"""Rows the engine's scheduler decodes per fused step: tokens emitted over
steps, from the engine's own counters (``stats()`` deltas over the traced
run's untraced window)."""


def read(t):
    stats = t.host.get("stats", {})
    steps = stats.get("decode_steps", 0)
    if not steps:
        return None
    return stats["tokens_emitted"] / steps
