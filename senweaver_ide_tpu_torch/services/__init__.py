"""Aux services (PyTorch port).

Of the JAX package's ``services/`` this slice takes ``skills`` (the
skills catalog of the system message) and ``perf_monitor`` (stage
thresholds and the ``torch.profiler`` capture of a GRPO round). The
dashboard, collaboration, extensions, metrics, config, model refresh,
onboarding and SCM services come with the host-plane slice.
"""

from .perf_monitor import (DEFAULT_THRESHOLDS_MS, PerformanceMonitor,
                           profile_capture)
from .skills import SkillInfo, SkillService

__all__ = [
    "DEFAULT_THRESHOLDS_MS", "PerformanceMonitor", "profile_capture",
    "SkillInfo", "SkillService",
]
