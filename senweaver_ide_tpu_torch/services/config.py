"""Tiered runtime configuration with live overrides + model gating.

Mirrors the reference's four config tiers (SURVEY.md §5):
(1) build-time product config (product.json senweaverApiConfig),
(2) persisted user settings (SenweaverSettingsService: per-feature model
    selection, chatMode, autoApprove map),
(3) live online config pushed at runtime with model-access gating
    (senweaverOnlineConfigContribution.ts:53-76 isOwnProviderEnabled),
(4) const tables (context/token_config.py, manager_types.py — already
    their own modules).

Resolution order: live override > user setting > build default.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional

# Tier 1: build-time defaults (the product.json analogue).
BUILD_DEFAULTS: Dict[str, Any] = {
    "chat_mode": "agent",
    "auto_approve": {"edits": True, "terminal": True, "MCP tools": True},
    "feature_models": {
        # Per-feature model selection (settings tier 2 overrides).
        "chat": "qwen2.5-coder-1.5b",
        "autocomplete": "qwen2.5-coder-1.5b",
        "quick_edit": "qwen2.5-coder-1.5b",
        "apply": "qwen2.5-coder-1.5b",
        "scm": "qwen2.5-coder-1.5b",
    },
    "rollout": {"num_slots": 8, "max_len": 4096},
    "train": {"learning_rate": 1e-5, "group_size": 8},
}


class RuntimeConfig:
    def __init__(self, *, settings_path: Optional[str] = None):
        self._settings_path = settings_path
        self._user: Dict[str, Any] = {}
        self._live: Dict[str, Any] = {}
        self._allowed_models: Optional[List[str]] = None   # None = all
        self._lock = threading.Lock()
        self._listeners: List[Callable[[], None]] = []
        if settings_path and os.path.exists(settings_path):
            try:
                with open(settings_path) as f:
                    self._user = json.load(f)
            except (OSError, json.JSONDecodeError):
                self._user = {}

    # -- resolution ("live > user > default") ------------------------------
    def get(self, dotted_key: str, default: Any = None) -> Any:
        with self._lock:
            for tier in (self._live, self._user, BUILD_DEFAULTS):
                v: Any = tier
                for part in dotted_key.split("."):
                    if not isinstance(v, dict) or part not in v:
                        v = _MISSING
                        break
                    v = v[part]
                if v is not _MISSING:
                    return v
            return default

    # -- tier 2: user settings --------------------------------------------
    def get_user(self, dotted_key: str, default: Any = None) -> Any:
        """Read the user tier ONLY (no live-tier shadowing) — for
        read-modify-write persistence where resolving through the live
        tier would copy transient pushed values into user settings."""
        with self._lock:
            v: Any = self._user
            for part in dotted_key.split("."):
                if not isinstance(v, dict) or part not in v:
                    return default
                v = v[part]
            return v

    def set_user(self, dotted_key: str, value: Any) -> None:
        with self._lock:
            d = self._user
            parts = dotted_key.split(".")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = value
            self._persist()
        self._notify()

    def _persist(self) -> None:
        if not self._settings_path:
            return
        tmp = self._settings_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self._user, f, indent=2)
            os.replace(tmp, self._settings_path)
        except OSError:
            pass

    # -- tier 3: live online config ---------------------------------------
    def apply_live_config(self, config: Dict[str, Any]) -> None:
        """The WS-push path (senweaverOnlineConfigContribution): replaces
        the live tier atomically; 'allowed_models' gates model access."""
        with self._lock:
            self._live = dict(config)
            am = config.get("allowed_models")
            self._allowed_models = list(am) if am is not None else None
        self._notify()

    def is_model_allowed(self, model_name: str) -> bool:
        """Model-access gating (isOwnProviderEnabled semantics)."""
        with self._lock:
            if self._allowed_models is None:
                return True
            return any(a in model_name for a in self._allowed_models)

    def snapshot(self) -> Dict[str, Any]:
        """Consistent view of the live tier + gating (single lock hold)."""
        with self._lock:
            return {"live_keys": sorted(self._live.keys()),
                    "model_gating": (list(self._allowed_models)
                                     if self._allowed_models is not None
                                     else None)}

    # -- change notification ----------------------------------------------
    def on_change(self, fn: Callable[[], None]) -> None:
        self._listeners.append(fn)

    def _notify(self) -> None:
        for fn in list(self._listeners):
            try:
                fn()
            except Exception:
                pass


class _Missing:
    pass


_MISSING = _Missing()


class ModelAccessError(PermissionError):
    """A live-config gate (allowed_models) blocks this model."""


class GatedPolicyClient:
    """PolicyClient wrapper that honors live model-access gating.

    The reference enforces isOwnProviderEnabled at the point of use —
    a pushed config change affects the NEXT request, not a restart
    (``senweaverOnlineConfigContribution.ts:53-76``). Wrapping the policy
    client is the session-layer equivalent: every chat() re-checks the
    gate against the CURRENT live tier, so a ``config.push`` lands on a
    running trainer/session mid-rollout. The agent loop's error path
    turns a gated call into an errored episode (record_error → trace
    hasErrors) rather than a crash of the surrounding job."""

    def __init__(self, inner, config: "RuntimeConfig", *,
                 model_name: Optional[str] = None):
        self.inner = inner
        self.config = config
        self.model_name = model_name or getattr(inner, "model_name", "") \
            or "local-policy"

    def chat(self, messages, **kw):
        if not self.config.is_model_allowed(self.model_name):
            raise ModelAccessError(
                f"model '{self.model_name}' is gated by live config "
                f"(allowed_models={self.config.snapshot()['model_gating']})")
        return self.inner.chat(messages, **kw)

    def __getattr__(self, name):
        # call_log, release_held_slot, tokenizer … pass through so the
        # RL data pipeline sees the real client underneath.
        return getattr(self.inner, name)


def install_config_channel(server, config: "RuntimeConfig"):
    """Online-config push channel over the trainer's JSON-RPC socket.

    The reference pushes live config over a global WebSocket and reports
    model usage back on the same channel
    (browser/senweaverOnlineConfigContribution.ts:53-76
    isOwnProviderEnabled / sendModelUsageReport). Here the trainer's
    control server (runtime/control.py) IS the push channel: an operator
    (or the C++ senweaver-ctl CLI) can push overrides into the live tier
    at runtime without restarting training.

    Registers three methods and returns the usage-report sink:
      - ``config.push {..overrides.., allowed_models?}`` → replaces the
        live tier atomically (model gating included)
      - ``config.get {"key": dotted}`` → resolved value ("live > user >
        default"); no key → {"live_keys": [...], "model_gating": [...]}
      - ``config.usage_report {model, tokens, ...}`` → appended to the
        returned deque (the sendModelUsageReport analogue), bounded at
        1000 entries so a long-running trainer doesn't leak
    """
    from collections import deque
    usage_reports: Any = deque(maxlen=1000)

    def _push(params: Any) -> Dict[str, Any]:
        if not isinstance(params, dict):
            raise ValueError("config.push expects an object of overrides")
        config.apply_live_config(params)
        return {"ok": True, "keys": sorted(params.keys())}

    def _get(params: Any) -> Any:
        if isinstance(params, dict) and "key" in params:
            return config.get(str(params["key"]))
        return config.snapshot()

    def _usage(params: Any) -> Dict[str, Any]:
        if not isinstance(params, dict):
            raise ValueError("config.usage_report expects an object")
        usage_reports.append(dict(params))
        return {"ok": True, "count": len(usage_reports)}

    server.register("config.push", _push)
    server.register("config.get", _get)
    server.register("config.usage_report", _usage)
    return usage_reports
