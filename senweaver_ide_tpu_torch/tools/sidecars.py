"""Sidecar tool backends: fetch_url / api_request / read_document / web_search.

The reference runs these as localhost Node HTTP servers spawned per tool
(``browser/start*.cjs``, 11.6k LoC: fetchUrl 2201, apiRequest 391,
documentReader 3793, webSearch 1482 — SURVEY.md §2.5/L8). The TPU build
has no Electron renderer to keep heavy work out of, so the equivalents are
in-process handlers plugged into ToolsService.register_handler — same tool
contract, no server lifecycle:

- ``fetch_url``: urllib GET with byte/char caps and an HTML→readable-text
  pass (the reference's cheerio/readability stage, startFetchUrlServer.cjs).
- ``api_request``: arbitrary-method HTTP with JSON header parsing and a
  capped response envelope (startApiRequestServer.cjs).
- ``read_document``: workspace-sandboxed text/markdown/CSV/JSON plus
  stdlib-only docx/xlsx extraction (zip+XML — no binary deps); the 3793-LoC
  reader's conversion matrix stays external (startDocumentReaderServer.cjs).
- ``web_search``: pluggable engine list (the reference rotates 8 engines,
  startWebSearchServer.cjs:3,:1025-1027); with no engines or no network it
  returns an OK-shaped empty result set instead of a failed tool call, so
  offline rollouts stop recording spurious failures in reward dims 3/4.
"""

from __future__ import annotations

import csv
import dataclasses
import html as _html
import io
import json
import re
import time
import urllib.error
import urllib.request
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence

from .sandbox import Workspace

SearchEngine = Callable[[str, int], List[Dict[str, str]]]


@dataclasses.dataclass
class SidecarConfig:
    timeout_s: float = 15.0
    max_fetch_bytes: int = 2_000_000
    default_max_length: int = 50_000
    user_agent: str = "senweaver-ide-tpu/0.2"
    # Search engines: ALL are queried concurrently and rank-merged
    # (the reference's 8-engine rotation, startWebSearchServer.cjs).
    search_engines: Sequence[SearchEngine] = ()
    # Cap on concurrently-queried engines per search.
    fanout: int = 8
    # Optional URL predicate for fetch_url/api_request (e.g. allowlist).
    url_filter: Optional[Callable[[str], bool]] = None


def html_to_text(markup: str) -> str:
    """Readable-text extraction (the reference's readability stage,
    collapsed to stdlib): drop script/style/head, convert structural tags
    to line breaks, strip the rest, unescape entities."""
    s = re.sub(r"(?is)<(script|style|head|noscript|template)[^>]*>.*?</\1>",
               " ", markup)
    s = re.sub(r"(?i)<(br|/p|/div|/li|/tr|/h[1-6]|/section|/article)[^>]*>",
               "\n", s)
    s = re.sub(r"(?s)<[^>]+>", " ", s)
    s = _html.unescape(s)
    s = re.sub(r"[ \t\r\f\v]+", " ", s)
    s = re.sub(r" *\n *", "\n", s)
    s = re.sub(r"\n\n+", "\n\n", s)
    return s.strip()


def _title_of(markup: str) -> str:
    m = re.search(r"(?is)<title[^>]*>(.*?)</title>", markup)
    return _html.unescape(m.group(1)).strip() if m else ""


class SidecarServices:
    """In-process backends for the reference's sidecar-served tools."""

    def __init__(self, workspace: Workspace,
                 config: Optional[SidecarConfig] = None):
        self.workspace = workspace
        self.config = config or SidecarConfig()

    def install(self, tools) -> None:
        """Register every backend on a ToolsService."""
        tools.register_handler("fetch_url", self.fetch_url)
        tools.register_handler("api_request", self.api_request)
        tools.register_handler("read_document", self.read_document)
        tools.register_handler("web_search", self.web_search)

    # -- fetch_url (startFetchUrlServer.cjs) ------------------------------
    def fetch_url(self, p: Dict[str, Any]) -> Dict[str, Any]:
        url = p["url"]
        self._check_url(url)
        max_length = int(p.get("max_length") or
                         self.config.default_max_length)
        start_index = int(p.get("start_index") or 0)
        raw, content_type, final_url = self._get(url)
        if "html" in content_type:
            text = html_to_text(raw)
            title = _title_of(raw)
        else:
            text, title = raw, ""
        window = text[start_index:start_index + max_length]
        return {
            "url": final_url, "title": title, "content": window,
            "content_type": content_type, "total_length": len(text),
            "start_index": start_index,
            "truncated": start_index + len(window) < len(text),
        }

    # -- api_request (startApiRequestServer.cjs) --------------------------
    def api_request(self, p: Dict[str, Any]) -> Dict[str, Any]:
        url = p["url"]
        self._check_url(url)
        method = str(p.get("method") or "GET").upper()
        headers = {"User-Agent": self.config.user_agent}
        raw_headers = p.get("headers")
        if raw_headers:
            parsed = (json.loads(raw_headers)
                      if isinstance(raw_headers, str) else raw_headers)
            if not isinstance(parsed, dict):
                raise ValueError("headers must be a JSON object")
            headers.update({str(k): str(v) for k, v in parsed.items()})
        body = p.get("body")
        data = body.encode() if isinstance(body, str) else body
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(
                    req, timeout=self.config.timeout_s) as resp:
                payload = resp.read(self.config.max_fetch_bytes)
                status = resp.status
                resp_headers = dict(resp.headers)
        except urllib.error.HTTPError as e:
            payload = e.read()[: self.config.max_fetch_bytes]
            status = e.code
            resp_headers = dict(e.headers or {})
        text = payload.decode(errors="replace")
        return {"status": status, "headers": resp_headers,
                "body": text[: self.config.default_max_length],
                "truncated": len(text) > self.config.default_max_length,
                "duration_ms": round((time.monotonic() - t0) * 1000, 1)}

    # -- read_document (startDocumentReaderServer.cjs) --------------------
    def read_document(self, p: Dict[str, Any]) -> Dict[str, Any]:
        uri = p["uri"]
        path = self.workspace.resolve(uri)
        if not path.is_file():
            raise FileNotFoundError(f"document does not exist: {uri}")
        suffix = path.suffix.lower()
        if suffix == ".docx":
            text = self._docx_text(path)
        elif suffix == ".xlsx":
            text = self._xlsx_text(path)
        elif suffix == ".csv":
            text = self._csv_text(path)
        elif suffix == ".json":
            text = json.dumps(json.loads(path.read_text(errors="replace")),
                              indent=2, ensure_ascii=False)
        elif suffix in (".txt", ".md", ".markdown", ".rst", ".log", ""):
            text = path.read_text(errors="replace")
        elif suffix == ".pdf":
            from .documents import minipdf_extract_pages
            text = "\n\n".join(minipdf_extract_pages(path.read_bytes()))
        elif suffix == ".pptx":
            from .documents import pptx_text
            text = pptx_text(path)
        elif suffix in (".doc", ".xls", ".ppt"):
            raise ValueError(
                f"legacy {suffix} extraction needs an external converter "
                f"in this hermetic build (reference: documentReader "
                f"sidecar)")
        else:
            text = path.read_text(errors="replace")
        start = int(p.get("start_index") or 0)
        cap = int(p.get("max_length") or self.config.default_max_length)
        window = text[start:start + cap]
        return {"uri": uri, "format": suffix or "text", "content": window,
                "total_length": len(text), "start_index": start,
                "truncated": start + len(window) < len(text)}

    # -- web_search (startWebSearchServer.cjs) ----------------------------
    def web_search(self, p: Dict[str, Any]) -> Dict[str, Any]:
        """Multi-engine fan-out → rank-merge (startWebSearchServer.cjs
        :1025-1027 rotates 8 engines; here ALL configured engines are
        queried CONCURRENTLY and their result lists fuse by reciprocal
        rank, so one slow/flaky engine neither blocks nor biases the
        answer). Dedup is by URL; an engine that throws only drops its
        own votes. With zero engines (the hermetic default) this stays
        an OK-shaped empty result, not a failed tool call."""
        import concurrent.futures as _fut

        query = p["query"]
        limit = int(p.get("max_results") or 10)
        engines = list(self.config.search_engines)[:self.config.fanout]
        errors: List[str] = []
        per_engine: List[tuple] = []     # (engine_name, results)
        if engines:
            # No context manager: its exit JOINS workers, so one wedged
            # engine would stall every search. Bounded wait + abandon.
            pool = _fut.ThreadPoolExecutor(max_workers=len(engines))
            futs = {pool.submit(e, query, limit):
                    getattr(e, "__name__", f"engine{i}")
                    for i, e in enumerate(engines)}
            pending = set(futs)
            try:
                for f in _fut.as_completed(futs,
                                           timeout=self.config.timeout_s):
                    pending.discard(f)
                    name = futs[f]
                    try:
                        per_engine.append((name, list(f.result())[:limit]))
                    except Exception as e:   # engine down → skip its votes
                        errors.append(f"{name}: {type(e).__name__}")
            except _fut.TimeoutError:        # stragglers forfeit their votes
                for f in pending:
                    errors.append(f"{futs[f]}: timeout")
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
        # Reciprocal-rank fusion over URL identity: score(url) =
        # Σ_engines 1/(K + rank); K=60 is the standard RRF constant.
        fused: Dict[str, Dict[str, Any]] = {}
        K = 60.0
        # Deterministic fold order; key on the NAME only (two engines may
        # share a __name__, and result dicts don't compare).
        for name, results in sorted(per_engine, key=lambda t: t[0]):
            for rank, r in enumerate(results):
                url = r.get("url") or r.get("link") or r.get("title", "")
                entry = fused.setdefault(
                    url, {"result": dict(r), "score": 0.0, "engines": []})
                entry["score"] += 1.0 / (K + rank)
                entry["engines"].append(name)
        ranked = sorted(fused.values(), key=lambda e: -e["score"])[:limit]
        if ranked:
            return {"query": query,
                    "results": [{**e["result"],
                                 "engines": e["engines"]} for e in ranked],
                    "engines_queried": len(engines),
                    "engines_failed": len(errors)}
        # Graceful offline degradation: an OK result with zero hits (the
        # model sees "no results", not a failed tool call).
        return {"query": query, "results": [],
                "note": "no search engine available"
                        + (f" ({'; '.join(errors)})" if errors else "")}

    def text_fetcher(self) -> Callable[[str], str]:
        """``fetch(url) -> body text`` over this sidecar's HTTP stack
        (UA, timeout, byte cap, url_filter) — the injection point for
        the concrete search-engine adapters (tools/search_engines.py):

            cfg.search_engines = default_engines(svc.text_fetcher())
        """
        def fetch(url: str) -> str:
            self._check_url(url)
            raw, _ctype, _final = self._get(url)
            return raw
        return fetch

    # -- internals --------------------------------------------------------
    def _check_url(self, url: str) -> None:
        if self.config.url_filter is not None \
                and not self.config.url_filter(url):
            raise PermissionError(f"URL not allowed by policy: {url}")

    def _get(self, url: str) -> tuple[str, str, str]:
        req = urllib.request.Request(
            url, headers={"User-Agent": self.config.user_agent})
        with urllib.request.urlopen(
                req, timeout=self.config.timeout_s) as resp:
            raw = resp.read(self.config.max_fetch_bytes)
            ctype = (resp.headers.get("Content-Type") or "").lower()
            return raw.decode(errors="replace"), ctype, resp.url

    @staticmethod
    def _docx_text(path) -> str:
        with zipfile.ZipFile(path) as z:
            xml = z.read("word/document.xml").decode(errors="replace")
        paras = re.split(r"</w:p>", xml)
        lines = []
        for para in paras:
            runs = re.findall(r"<w:t[^>]*>(.*?)</w:t>", para, flags=re.S)
            if runs:
                lines.append(_html.unescape("".join(runs)))
        return "\n".join(lines)

    @staticmethod
    def _xlsx_text(path) -> str:
        with zipfile.ZipFile(path) as z:
            shared: List[str] = []
            if "xl/sharedStrings.xml" in z.namelist():
                sxml = z.read("xl/sharedStrings.xml").decode(errors="replace")
                shared = [_html.unescape(re.sub(r"(?s)<[^>]+>", "", si))
                          for si in re.findall(r"(?s)<si>(.*?)</si>", sxml)]
            sheets = sorted(n for n in z.namelist()
                            if re.match(r"xl/worksheets/sheet\d+\.xml$", n))
            out: List[str] = []
            for name in sheets:
                xml = z.read(name).decode(errors="replace")
                for row in re.findall(r"(?s)<row[^>]*>(.*?)</row>", xml):
                    cells = []
                    for attrs, val in re.findall(
                            r"(?s)<c\b([^>]*)>.*?<v>(.*?)</v>", row):
                        if re.search(r'\bt="s"', attrs):
                            idx = int(val)
                            cells.append(shared[idx]
                                         if idx < len(shared) else val)
                        else:
                            cells.append(val)
                    if cells:
                        out.append("\t".join(cells))
            return "\n".join(out)

    def _csv_text(self, path) -> str:
        text = path.read_text(errors="replace")
        rows = list(csv.reader(io.StringIO(text)))
        return "\n".join("\t".join(row) for row in rows)
