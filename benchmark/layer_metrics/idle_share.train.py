"""Share of the traced window in which no kernel, copy or set ran on the
device: 1 - busy / window. The profiler slows a host-bound step, so this
bounds the untraced idle share from above."""


def read(t):
    return 1.0 - t.trace.busy_s / t.trace.window_s
