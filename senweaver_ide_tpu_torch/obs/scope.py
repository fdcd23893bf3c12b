"""Process-wide observability state, saved and put back.

The report selftests reset the global tracer and registry
(``obs._reset_for_tests``), turn tracing on and install event journals
of their own. :func:`preserved_obs` runs such a block on fresh globals
and puts the caller's back afterwards, so several of them run one after
another in one process without one reading another's series, spans or
journal, and the process's own state comes out as it went in::

    with preserved_obs():
        selftest(device="cuda")

It also decorates a function (``@preserved_obs()``).
"""

from __future__ import annotations

import contextlib

import senweaver_ide_tpu_torch.obs as _obs

from . import incidents, runtime_profile, training_health
from .metrics import MetricsRegistry
from .tracing import Tracer


@contextlib.contextmanager
def preserved_obs():
    """Run the block on a fresh tracer (off), registry, health monitor,
    profiler and event journal; restore the previous ones on exit, even
    when the block raises. The caller's tracer is never closed."""
    with _obs._lock:
        saved = (_obs._tracer, _obs._registry)
        _obs._tracer = Tracer(enabled=False)
        _obs._registry = MetricsRegistry()
    monitor = training_health.set_health_monitor(None)
    with runtime_profile._profiler_lock:
        profiler = runtime_profile._profiler
    with incidents._journal_lock:
        journal = incidents._journal
    runtime_profile.set_profiler(None)
    incidents.set_event_journal(None)
    try:
        yield
    finally:
        with _obs._lock:
            inner = _obs._tracer
            _obs._tracer, _obs._registry = saved
        training_health.set_health_monitor(monitor)
        runtime_profile.set_profiler(profiler)
        incidents.set_event_journal(journal)
        if inner is not saved[0]:
            inner.close()
