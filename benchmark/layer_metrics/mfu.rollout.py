"""Model FLOPs of every token the engine's fused steps ran (prefilled or
generated, the head included, no embedding gather) over the untraced
window's time on the host's clock at the card's bf16 peak, in percent."""

from benchmark import yardstick


def read(t):
    steps = t.host.get("steps", [])
    if t.peak is None or not steps:
        return None
    flops = sum(yardstick.forward_flops(t.cfg, s["tokens"], s["context_sum"])
                for s in steps)
    return 100.0 * flops / (t.host["window_s"] * t.peak["bf16_flops"])
