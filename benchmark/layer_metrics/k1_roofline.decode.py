"""K1 (paged attention) against its roofline over the traced window: the
least time the work of every fused step needs, over the device time of
the kernels named below, in percent.

The work is the harness's own record of each step: its tokens, their
visible contexts (q.k and p.v over every visible key), and the distinct
K/V positions the traffic makes them read, each read once at its stored
width: a prompt's common system part once for all rows, a group's prompt
once for all of its members, the rest row by row; q read and out written
once, one table entry a block of each row and one length a token."""

from benchmark import yardstick

# the paged-attention kernels (ops/paged_attention.py)
KERNELS = ("pfd_split_kernel", "pfd_merge_kernel", "pfd_kernel")


def read(t):
    if t.peak is None or not t.steps:
        return None
    busy = t.trace.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    bs = t.traffic["block_size"]
    need = 0.0
    for s in t.steps:
        blocks = sum(-(-r // bs) for r in s["reads"])
        flops, nbytes = yardstick.k1_work(t.cfg, s["distinct"], s["tokens"],
                                          s["context_sum"], blocks)
        need += yardstick.bound_seconds(flops, nbytes, t.peak)
    return 100.0 * need / busy
