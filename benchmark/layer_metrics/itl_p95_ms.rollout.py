"""The 95th percentile of the gaps between consecutive tokens of every
request, both tokens in the traced run's untraced window, on the host's
clock: each gap is a fused step of the engine, so this is the scheduler's
tail step time as a request sees it."""


def read(t):
    return t.host.get("itl_p95_ms")
