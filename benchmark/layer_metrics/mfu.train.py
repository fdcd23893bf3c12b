"""Model FLOPs of the finished steps' non-padding positions (forward and
backward, 3x the forward; no recomputation, no embedding gather) over the
untraced window's time on the host's clock (to the last step's
synchronised end) at the card's bf16 peak, in percent."""

from benchmark import yardstick


def read(t):
    steps = t.host.get("steps", [])
    if t.peak is None or not steps:
        return None
    flops = sum(yardstick.train_flops(t.cfg, lens) for lens in steps)
    return 100.0 * flops / (t.host["window_s"] * t.peak["bf16_flops"])
