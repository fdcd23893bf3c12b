"""The CUDA caching allocator's peak of allocated memory over the traced
run's windows (``torch.cuda.max_memory_allocated`` after a reset at their
start):
weights, gradients, optimizer state and the step's activations, in GiB."""


def read(t):
    if not t.mem_window_peak_bytes:
        return None
    return t.mem_window_peak_bytes / 2 ** 30
