"""K2 (flash attention, forward and backward) against its roofline over
the traced window: the least time the causal attention of the finished
steps' sequences needs (forward, and dP, dV, dQ, dK; padding and the
remat forward not counted), over the device time of the kernels named
below, in percent."""

from benchmark import yardstick

# the flash-attention kernels (ops/flash_attention.py)
KERNELS = ("fa_fwd_kernel", "fa_fwd_mma_kernel", "fa_bwd_dkdv_kernel",
           "fa_bwd_dkdv_mma_kernel", "fa_bwd_dkdv_fold_kernel",
           "fa_bwd_dq_kernel", "fa_bwd_dq_mma_kernel")


def read(t):
    if t.peak is None or not t.steps:
        return None
    busy = t.trace.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    need = 0.0
    for lens in t.steps:
        flops, nbytes = yardstick.k2_work(t.cfg, lens)
        need += yardstick.bound_seconds(flops, nbytes, t.peak)
    return 100.0 * need / busy
