"""The port's remote-LLM transports (``senweaver_ide_tpu_torch/transport/``)
against loopback fake servers, beside the JAX package's clients.

Mirrors tests/test_transport.py and tests/test_transport_native.py: the
openai-compatible, Anthropic-messages and Gemini clients each against
one in-process server speaking all three wire formats. Per client: a
roundtrip whose request body and headers equal the JAX client's for the
same messages; a 429 mapped onto the port's ``RateLimitError`` with its
retry-after fed to the port's rate limiter; a context-length 400 mapped
onto the port's ``ContextLengthError`` (the class the port's agent loop
catches); an unreachable endpoint raising ``TransportUnavailable``. Then
the provider registry equals the JAX package's and every provider's
default model lands on a real entry of the port's
``models/capabilities.py``.
"""

import http.server
import json
import threading

import pytest
import torch

from senweaver_ide_tpu import transport as jtransport
from senweaver_ide_tpu.agents.llm import ChatMessage as JaxMessage
from senweaver_ide_tpu.context.rate_limiter import \
    TPMRateLimiter as JaxLimiter
from senweaver_ide_tpu_torch import transport
from senweaver_ide_tpu_torch.agents.llm import (ChatMessage,
                                                ContextLengthError,
                                                RateLimitError)
from senweaver_ide_tpu_torch.context.rate_limiter import TPMRateLimiter
from senweaver_ide_tpu_torch.models.capabilities import (
    _DEFAULT, get_model_capabilities)

SEEN = []


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model engine steps are thousands of small ops: with several
    pytest-xdist workers, torch's default thread pool in each of them
    oversubscribes the host's cores and spins, several times slower than
    one thread. The previous setting is restored for the next module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Handler(http.server.BaseHTTPRequestHandler):
    """One server, three wire formats; the model name picks the fault."""

    def log_message(self, *a):
        pass

    def _reply(self, code, payload, headers=()):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        body = json.loads(self.rfile.read(
            int(self.headers["Content-Length"])))
        headers = {k.lower(): v for k, v in self.headers.items()
                   if k.lower() in ("x-api-key", "anthropic-version",
                                    "x-goog-api-key", "authorization")}
        SEEN.append((self.path, body, headers))
        model = body.get("model") or self.path.split("/models/")[-1].split(
            ":")[0]
        if model == "rate-limited":
            self._reply(429, {"error": "slow down"}, [("retry-after", "3")])
            return
        if model == "too-long":
            self._reply(400, {"error": {"message": "This model's maximum "
                                        "context length is 8192 tokens"}})
            return
        if self.path.endswith("/chat/completions"):
            self._reply(200, {"model": body["model"], "choices": [
                {"message": {"role": "assistant", "content": "compat hi"}}],
                "usage": {"prompt_tokens": 7, "completion_tokens": 3}})
        elif self.path == "/v1/messages":
            self._reply(200, {"model": body["model"],
                              "content": [{"type": "text",
                                           "text": "claude hi"}],
                              "usage": {"input_tokens": 12,
                                        "output_tokens": 5}})
        elif ":generateContent" in self.path:
            self._reply(200, {"candidates": [{"content": {"parts": [
                {"text": "gemini "}, {"text": "hi"}]}}],
                "usageMetadata": {"promptTokenCount": 9,
                                  "candidatesTokenCount": 4},
                "modelVersion": "gemini-test"})
        else:
            self._reply(404, {"error": "unknown path"})


@pytest.fixture(scope="module")
def server():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


# (client class name, provider, base path suffix, reply text, usage in)
CLIENTS = [
    ("OpenAICompatClient", "openai-compatible", "/v1", "compat hi", 7),
    ("AnthropicMessagesClient", "anthropic", "", "claude hi", 12),
    ("GeminiClient", "gemini", "", "gemini hi", 9),
]


def _client(pkg, name, provider, base, model, limiter):
    cls = getattr(pkg, name)
    if name == "OpenAICompatClient":
        return cls(provider, model=model, base_url=base, api_key="k-1",
                   rate_limiter=limiter, timeout_s=5.0)
    return cls(base_url=base, api_key="k-1", model=model,
               rate_limiter=limiter)


def _messages(msg_cls):
    return [msg_cls("system", "be brief"), msg_cls("user", "hello"),
            msg_cls("assistant", "prev"),
            msg_cls("tool", "ok", tool_name="read_file")]


@pytest.mark.parametrize("name,provider,suffix,text,n_in", CLIENTS,
                         ids=[c[0] for c in CLIENTS])
def test_client_against_loopback_like_jax(server, name, provider, suffix,
                                          text, n_in):
    base = server + suffix
    SEEN.clear()
    got = _client(transport, name, provider, base, "m-1",
                  TPMRateLimiter()).chat(_messages(ChatMessage),
                                         temperature=0.3, max_tokens=64)
    want = _client(jtransport, name, provider, base, "m-1",
                   JaxLimiter()).chat(_messages(JaxMessage),
                                      temperature=0.3, max_tokens=64)
    assert got.text == want.text == text
    assert got.usage.input_tokens == want.usage.input_tokens == n_in
    assert len(SEEN) == 2 and SEEN[0] == SEEN[1]     # the same request

    limiter = TPMRateLimiter()
    with pytest.raises(RateLimitError) as e:
        _client(transport, name, provider, base, "rate-limited",
                limiter).chat([ChatMessage("user", "x")])
    assert e.value.retry_after_s == 3.0
    if name == "OpenAICompatClient":
        assert limiter.get_wait_time(provider) > 0
    with pytest.raises(ContextLengthError):
        _client(transport, name, provider, base, "too-long",
                TPMRateLimiter()).chat([ChatMessage("user", "x" * 100)])


@pytest.mark.parametrize("name,provider", [(c[0], c[1]) for c in CLIENTS],
                         ids=[c[0] for c in CLIENTS])
def test_unreachable_endpoint_raises_transport_unavailable(name, provider):
    c = _client(transport, name, provider, "http://127.0.0.1:9", "m",
                TPMRateLimiter())
    if hasattr(c, "timeout_s"):
        c.timeout_s = 1.0
    with pytest.raises(transport.TransportUnavailable):
        c.chat([ChatMessage("user", "hi")])


def test_make_client_and_fim(server):
    assert isinstance(transport.make_client("anthropic", base_url=server,
                                            api_key="k"),
                      transport.AnthropicMessagesClient)
    assert isinstance(transport.make_client("gemini", base_url=server,
                                            api_key="k"),
                      transport.GeminiClient)
    with pytest.raises(ValueError, match="local"):
        transport.make_client("local")
    with pytest.raises(transport.TransportUnavailable,
                       match="does not support"):
        transport.OpenAICompatClient(
            "openai", model="gpt-4o", base_url=server,
            rate_limiter=TPMRateLimiter()).fim_complete("a", "b")


def test_providers_equal_jax_and_resolve_port_capabilities():
    assert {k: vars(v) for k, v in transport.PROVIDERS.items()} == {
        k: vars(v) for k, v in jtransport.PROVIDERS.items()}
    assert {p.endpoint_style for p in transport.PROVIDERS.values()} == {
        "local", "openai-compat", "anthropic", "gemini"}
    for name, p in transport.PROVIDERS.items():
        if not p.default_model:
            continue
        caps = get_model_capabilities(p.default_model)
        assert caps.context_window > 0 and caps is not _DEFAULT, name
    assert transport.resolve_model("mistral") == ("mistral",
                                                  "codestral-latest")
    assert transport.resolve_model("nope", "m")[0] == "local"
