"""Model-list refresh + user-defined API endpoints.

``RefreshModelService`` is the counterpart of the reference's
RefreshModelService (common/refreshModelService.ts, 222 LoC): poll an
openai-compatible provider's ``GET /models`` endpoint, keep a
per-provider state machine (init → refreshing → finished_success |
finished_error), notify listeners on change, and optionally auto-poll on
an interval — the mechanism the reference uses to discover locally
served models (Ollama / vLLM / LM Studio).

``CustomApiService`` is the counterpart of CustomApiService
(common/customApiService.ts, 216 LoC): user-defined openai-compatible
endpoints, persisted in the user config tier and registered as live
providers so the transport layer (transport/http_client.py) can drive
them by name.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from ..transport.providers import PROVIDERS, ProviderSettings, get_provider
from .config import RuntimeConfig

# Providers whose model list is meaningfully dynamic (locally served
# engines), mirroring the reference's refreshable set.
REFRESHABLE_PROVIDERS = (
    "ollama", "vllm", "lmstudio", "litellm", "openai-compatible")

STATE_INIT = "init"
STATE_REFRESHING = "refreshing"
STATE_SUCCESS = "finished_success"
STATE_ERROR = "finished_error"


def fetch_model_list(settings: ProviderSettings, *,
                     timeout_s: float = 5.0) -> List[str]:
    """GET ``{base_url}/models`` and return model ids.

    Accepts both the openai-compatible shape ``{"data": [{"id": ...}]}``
    and the bare ``{"models": [{"name"|"id": ...}]}`` shape some local
    engines return.
    """
    if not settings.base_url:
        raise ValueError(f"provider {settings.name} has no base_url")
    url = settings.base_url.rstrip("/") + "/models"
    req = urllib.request.Request(url, headers={"Accept": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        payload = json.loads(resp.read().decode("utf-8", errors="replace"))
    if isinstance(payload, list):            # bare-array shape
        entries = payload
    else:
        entries = payload.get("data") or payload.get("models") or []
    out: List[str] = []
    for e in entries:
        if isinstance(e, str):
            out.append(e)
        elif isinstance(e, dict):
            mid = e.get("id") or e.get("name")
            if mid:
                out.append(str(mid))
    return out


class RefreshModelService:
    """Per-provider model-list polling with a refresh state machine."""

    def __init__(self, *, fetcher: Optional[Callable[
            [ProviderSettings], List[str]]] = None):
        self._fetch = fetcher or fetch_model_list
        self._states: Dict[str, str] = {}
        self._models: Dict[str, List[str]] = {}
        self._errors: Dict[str, str] = {}
        self._listeners: List[Callable[[str], None]] = []
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._auto_gen = 0
        self._auto_providers: List[str] = []
        self._interval_s = 0.0

    # -- state inspection --------------------------------------------------
    def state_of(self, provider: str) -> str:
        with self._lock:
            return self._states.get(provider, STATE_INIT)

    def models_of(self, provider: str) -> List[str]:
        with self._lock:
            return list(self._models.get(provider, []))

    def error_of(self, provider: str) -> Optional[str]:
        with self._lock:
            return self._errors.get(provider)

    def on_change(self, fn: Callable[[str], None]) -> None:
        self._listeners.append(fn)

    # -- refresh -----------------------------------------------------------
    def refresh(self, provider: str) -> List[str]:
        """Synchronously refresh one provider's model list."""
        settings = get_provider(provider)
        if settings is None:
            raise KeyError(f"unknown provider: {provider}")
        with self._lock:
            self._states[provider] = STATE_REFRESHING
        self._notify(provider)
        try:
            models = self._fetch(settings)
        except Exception as e:
            with self._lock:
                self._states[provider] = STATE_ERROR
                self._errors[provider] = f"{type(e).__name__}: {e}"
            self._notify(provider)
            return []
        with self._lock:
            self._states[provider] = STATE_SUCCESS
            self._models[provider] = list(models)
            self._errors.pop(provider, None)
        self._notify(provider)
        return list(models)

    def refresh_all(self,
                    providers: Optional[List[str]] = None) -> Dict[str, List[str]]:
        names = providers if providers is not None else [
            p for p in REFRESHABLE_PROVIDERS if p in PROVIDERS]
        return {name: self.refresh(name) for name in names}

    # -- auto-poll ---------------------------------------------------------
    # A generation counter makes start/stop race-free: each start_auto
    # invalidates every timer chain from earlier generations, so a slow
    # in-flight _tick from a previous chain cannot reschedule itself
    # alongside the new one.
    def start_auto(self, providers: List[str], interval_s: float) -> None:
        with self._lock:
            self._auto_gen = self._auto_gen + 1
            gen = self._auto_gen
            self._auto_providers = list(providers)
            self._interval_s = interval_s
            if self._timer is not None:
                self._timer.cancel()
        self._schedule(gen)

    def _schedule(self, gen: int) -> None:
        with self._lock:
            if gen != self._auto_gen:
                return
            self._timer = threading.Timer(self._interval_s, self._tick,
                                          args=(gen,))
            self._timer.daemon = True
            self._timer.start()

    def _tick(self, gen: int) -> None:
        with self._lock:
            if gen != self._auto_gen:
                return
            providers = list(self._auto_providers)
        for p in providers:
            try:
                self.refresh(p)
            except KeyError:
                pass
        self._schedule(gen)

    def stop_auto(self) -> None:
        with self._lock:
            self._auto_gen = self._auto_gen + 1
            t, self._timer = self._timer, None
        if t is not None:
            t.cancel()

    def _notify(self, provider: str) -> None:
        for fn in list(self._listeners):
            try:
                fn(provider)
            except Exception:
                pass


class CustomApiService:
    """User-defined openai-compatible endpoints.

    Endpoints are persisted under the ``custom_apis`` key of the user
    config tier and registered into the live provider registry under the
    name ``custom:{name}`` so `OpenAICompatClient("custom:x")` resolves.
    """

    PREFIX = "custom:"

    def __init__(self, config: Optional[RuntimeConfig] = None):
        self._config = config
        self._names: List[str] = []
        self._lock = threading.Lock()
        if config is not None:
            # User tier only: live-pushed endpoints are transient and must
            # not be resurrected from (or copied into) the settings file.
            stored = config.get_user("custom_apis", {}) or {}
            for name, spec in stored.items():
                if isinstance(spec, dict) and spec.get("base_url"):
                    self._register(name, spec)

    # -- CRUD --------------------------------------------------------------
    def add_endpoint(self, name: str, base_url: str, *,
                     api_key_env: str = "", default_model: str = "",
                     supports_fim: bool = False) -> ProviderSettings:
        if not name or not base_url:
            raise ValueError("custom endpoint needs a name and base_url")
        spec = {"base_url": base_url, "api_key_env": api_key_env,
                "default_model": default_model,
                "supports_fim": bool(supports_fim)}
        with self._lock:
            settings = self._register(name, spec)
            if self._config is not None:
                # Whole-dict write keyed off the USER tier (a dotted
                # set_user path would nest a name like "my.lab"; reading
                # the merged view would persist live-pushed endpoints).
                apis = dict(self._config.get_user("custom_apis", {}) or {})
                apis[name] = spec
                self._config.set_user("custom_apis", apis)
        return settings

    def remove_endpoint(self, name: str) -> None:
        with self._lock:
            PROVIDERS.pop(self.PREFIX + name, None)
            if name in self._names:
                self._names.remove(name)
            if self._config is not None:
                apis = dict(self._config.get_user("custom_apis", {}) or {})
                if name in apis:
                    del apis[name]
                    self._config.set_user("custom_apis", apis)

    def list_endpoints(self) -> List[str]:
        return list(self._names)

    def settings_of(self, name: str) -> Optional[ProviderSettings]:
        return PROVIDERS.get(self.PREFIX + name)

    def _register(self, name: str, spec: Dict[str, Any]) -> ProviderSettings:
        settings = ProviderSettings(
            self.PREFIX + name, "openai-compat",
            base_url=str(spec.get("base_url", "")),
            api_key_env=str(spec.get("api_key_env", "")),
            supports_fim=bool(spec.get("supports_fim", False)),
            default_model=str(spec.get("default_model", "")))
        PROVIDERS[settings.name] = settings
        if name not in self._names:
            self._names.append(name)
        return settings
