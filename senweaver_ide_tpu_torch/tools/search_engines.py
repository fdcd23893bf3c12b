"""Concrete web-search engine adapters for the fan-out merger.

The reference's webSearch sidecar rotates 8 engines (Baidu/Bing/DDG/
CSDN/Juejin/Weixin/GitHub/arXiv — ``startWebSearchServer.cjs:3``); the
TPU build's ``tools/sidecars.py web_search`` fans out over a pluggable
engine list and rank-merges. This module supplies the adapters: each is
a (query, limit) → results callable built over an injectable
``fetch(url) -> str`` so the PARSERS are hermetic-testable (zero-egress
environments test against canned fixtures; online deployments pass a
real fetcher, e.g. ``SidecarServices.text_fetcher()``).

Each result is ``{"title", "url", "snippet"}`` — the shape the RRF
merger dedups and scores.
"""

from __future__ import annotations

import html as _html
import json
import re
import urllib.parse
from typing import Callable, Dict, List

Fetch = Callable[[str], str]
Result = Dict[str, str]


def _clean(markup: str) -> str:
    return _html.unescape(re.sub(r"<[^>]+>", "", markup)).strip()


# -- DuckDuckGo (html.duckduckgo.com/html, no JS) -------------------------

def parse_ddg_html(page: str, limit: int) -> List[Result]:
    out: List[Result] = []
    anchor_re = re.compile(
        r'<a[^>]*class="[^"]*result__a[^"]*"[^>]*href="([^"]+)"[^>]*>'
        r'(.*?)</a>', re.S)
    matches = list(anchor_re.finditer(page))
    for i, m in enumerate(matches):
        # hrefs arrive HTML-entity-escaped ("&amp;uddg=..."): unescape
        # BEFORE query parsing or uddg is only found when first.
        url = _html.unescape(m.group(1))
        title = _clean(m.group(2))
        # DDG wraps targets in a redirect: uddg=<quoted real url>
        q = urllib.parse.urlparse(url).query
        real = urllib.parse.parse_qs(q).get("uddg", [url])[0]
        # Snippet search is bounded at the NEXT result's anchor — an
        # unbounded window would steal the following result's snippet
        # for any hit that has none of its own.
        end = (matches[i + 1].start() if i + 1 < len(matches)
               else len(page))
        snippet = ""
        sm = re.search(r'class="[^"]*result__snippet[^"]*"[^>]*>(.*?)</a>',
                       page[m.end():end], re.S)
        if sm:
            snippet = _clean(sm.group(1))[:300]
        out.append({"title": title, "url": real, "snippet": snippet})
        if len(out) >= limit:
            break
    return out


def duckduckgo_engine(fetch: Fetch):
    def duckduckgo(query: str, limit: int) -> List[Result]:
        page = fetch("https://html.duckduckgo.com/html/?q="
                     + urllib.parse.quote_plus(query))
        return parse_ddg_html(page, limit)
    return duckduckgo


# -- Bing (www.bing.com/search, classic HTML results) ---------------------

def parse_bing_html(page: str, limit: int) -> List[Result]:
    out: List[Result] = []
    for m in re.finditer(
            r'<li class="b_algo".*?<h2><a[^>]*href="([^"]+)"[^>]*>(.*?)'
            r"</a></h2>(.*?)</li>", page, re.S):
        # hrefs are HTML-attribute-escaped; an un-unescaped '&amp;'
        # breaks downstream fetches AND RRF dedup against other engines.
        url = _html.unescape(m.group(1))
        title, body = _clean(m.group(2)), m.group(3)
        sm = re.search(r"<p[^>]*>(.*?)</p>", body, re.S)
        out.append({"title": title, "url": url,
                    "snippet": _clean(sm.group(1))[:300] if sm else ""})
        if len(out) >= limit:
            break
    return out


def bing_engine(fetch: Fetch):
    def bing(query: str, limit: int) -> List[Result]:
        page = fetch("https://www.bing.com/search?q="
                     + urllib.parse.quote_plus(query))
        return parse_bing_html(page, limit)
    return bing


# -- GitHub repository search (REST JSON, no key for low volume) ----------

def parse_github_json(payload: str, limit: int) -> List[Result]:
    items = json.loads(payload).get("items", [])
    return [{"title": it.get("full_name", ""),
             "url": it.get("html_url", ""),
             "snippet": (it.get("description") or "")[:300]}
            for it in items[:limit]]


def github_engine(fetch: Fetch):
    def github(query: str, limit: int) -> List[Result]:
        payload = fetch("https://api.github.com/search/repositories?q="
                        + urllib.parse.quote_plus(query)
                        + f"&per_page={limit}")
        return parse_github_json(payload, limit)
    return github


# -- arXiv (Atom XML export API) ------------------------------------------

def parse_arxiv_atom(feed: str, limit: int) -> List[Result]:
    out: List[Result] = []
    for m in re.finditer(r"<entry>(.*?)</entry>", feed, re.S):
        entry = m.group(1)
        t = re.search(r"<title>(.*?)</title>", entry, re.S)
        i = re.search(r"<id>(.*?)</id>", entry, re.S)
        s = re.search(r"<summary>(.*?)</summary>", entry, re.S)
        out.append({
            "title": _clean(t.group(1)) if t else "",
            "url": (i.group(1).strip() if i else ""),
            "snippet": (_clean(s.group(1))[:300] if s else ""),
        })
        if len(out) >= limit:
            break
    return out


def arxiv_engine(fetch: Fetch):
    def arxiv(query: str, limit: int) -> List[Result]:
        feed = fetch("http://export.arxiv.org/api/query?search_query=all:"
                     + urllib.parse.quote_plus(query)
                     + f"&max_results={limit}")
        return parse_arxiv_atom(feed, limit)
    return arxiv


def default_engines(fetch: Fetch) -> tuple:
    """The standard fan-out set over one fetcher (order is merge-neutral:
    the RRF merger scores by rank agreement, not engine order)."""
    return (duckduckgo_engine(fetch), bing_engine(fetch),
            github_engine(fetch), arxiv_engine(fetch))
