"""Aux services: skills, extension tool servers, metrics, runtime config.

TPU-build analogues of the reference's L9 services (SURVEY.md §2.5):
skillService.ts, mcpService.ts/mcpChannel.ts, metricsService.ts, and the
tiered config system (product.json / settings / online config).
"""

from .collaboration import CollabCoordinator, CollabSession
from .config import (BUILD_DEFAULTS, GatedPolicyClient, ModelAccessError,
                     RuntimeConfig, install_config_channel)
from .dashboard import DashboardService
from .extensions import (ExtensionServer, ExtensionServerError,
                         ExtensionTool, ExtensionToolRegistry)
from .metrics import MetricsService, load_jsonl_metrics
from .model_refresh import (CustomApiService, RefreshModelService,
                            fetch_model_list)
from .onboarding import OnboardingService, install_onboarding_channel
from .perf_monitor import (DEFAULT_THRESHOLDS_MS, PerformanceMonitor,
                           profile_capture)
from .scm import GitRepo, SCMService, extract_commit_message
from .skills import SkillInfo, SkillService

__all__ = [
    "CollabCoordinator", "CollabSession",
    "BUILD_DEFAULTS", "GatedPolicyClient", "ModelAccessError",
    "RuntimeConfig", "install_config_channel",
    "ExtensionServer", "ExtensionServerError", "ExtensionTool",
    "DashboardService",
    "ExtensionToolRegistry", "MetricsService", "load_jsonl_metrics",
    "CustomApiService", "RefreshModelService", "fetch_model_list",
    "OnboardingService", "install_onboarding_channel",
    "GitRepo", "SCMService", "extract_commit_message",
    "SkillInfo", "SkillService",
]
