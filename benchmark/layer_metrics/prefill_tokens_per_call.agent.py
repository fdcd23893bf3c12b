"""Prompt tokens the engine prefilled per scheduled call, from its own
counters (``stats()`` deltas over the traced run's untraced window): what
the prefix plane left to compute of each conversation."""


def read(t):
    stats = t.host.get("stats", {})
    calls = stats.get("prefills", 0)
    if not calls:
        return None
    return stats["prefill_tokens"] / calls
