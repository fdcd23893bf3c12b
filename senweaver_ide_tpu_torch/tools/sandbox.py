"""Hermetic workspace sandbox for rollout tool calls.

The reference's tools operate on the user's real workspace through VS Code's
IFileService/ISearchService (toolsService.ts). For RL rollouts the reward's
validity depends on reproducibility (SURVEY.md §7 "Agent-loop hermeticity"),
so the TPU build confines every file tool to a sandbox root: paths are
resolved, normalized, and rejected if they escape the root. Semantics of the
individual operations mirror the reference tools:

- folder-vs-file creation by trailing slash (prompts.ts create_file_or_folder
  description; toolsService.ts callTool['create_file_or_folder'])
- recursive delete flag (delete_file_or_folder)
- paginated reads: MAX_FILE_CHARS_PAGE chars/page (prompts.ts:25)
- ls pagination: MAX_CHILDREN_URIS_PAGE entries/page (prompts.ts:26)
- bounded dir tree (directoryStrService.ts caps, prompts.ts:19-22)
"""

from __future__ import annotations

import fnmatch
import os
import re
import shutil
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

from ..context.token_config import (DIRECTORY_OPTIMIZATION,
                                    MAX_CHILDREN_URIS_PAGE,
                                    MAX_FILE_CHARS_PAGE)

# Directories never worth walking (reference search relies on ripgrep's
# default ignores; we approximate with a fixed skip list).
_SKIP_DIRS = {".git", "node_modules", "__pycache__", ".venv", "venv",
              ".cache", ".mypy_cache", ".pytest_cache", "dist", "build"}


class SandboxViolation(PermissionError):
    pass


class Workspace:
    """A rooted, escape-proof view of one rollout's filesystem."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root).resolve()
        self.root.mkdir(parents=True, exist_ok=True)

    # -- path resolution ---------------------------------------------------
    def resolve(self, path: str | os.PathLike) -> Path:
        """Resolve a model-provided path inside the sandbox root.

        Absolute paths are re-rooted (the model sees sandbox-absolute paths);
        anything resolving outside the root raises SandboxViolation.
        """
        p = str(path).strip()
        p = re.sub(r"<[^>]*>", "", p).strip()  # XML-tag cleanup, cf.
        # toolsService.ts:884-894 (URI cleaning of stray tags)
        if not p:
            raise SandboxViolation("empty path")
        candidate = Path(p)
        if candidate.is_absolute():
            try:
                rel = candidate.resolve().relative_to(self.root)
                candidate = self.root / rel
            except ValueError:
                # Re-root: /foo/bar → <root>/foo/bar
                candidate = self.root / p.lstrip("/")
        else:
            candidate = self.root / candidate
        # Full non-strict resolution: follows symlinks INCLUDING a dangling
        # final component (exists() is False for those, so a parent-only
        # resolve would let `ln -s /etc/target x` + write_file(x) create a
        # file outside the root).
        resolved = candidate.resolve(strict=False)
        if resolved != self.root and self.root not in resolved.parents:
            raise SandboxViolation(f"path escapes sandbox: {path}")
        return resolved

    def display(self, p: Path) -> str:
        """Sandbox-absolute display path (what the model sees)."""
        try:
            return "/" + str(p.relative_to(self.root))
        except ValueError:
            return str(p)

    # -- file ops ----------------------------------------------------------
    def read_text(self, path: str) -> str:
        """Full, unpaginated file contents (for edits and in-file search —
        pagination is a presentation concern only; editing through a page
        window would silently truncate the file)."""
        p = self.resolve(path)
        if not p.is_file():
            raise FileNotFoundError(f"file does not exist: {path}")
        return p.read_text(errors="replace")

    def read_file(self, path: str, *, start_line: Optional[int] = None,
                  end_line: Optional[int] = None,
                  page_number: int = 1) -> Tuple[str, bool]:
        """Read file contents; returns (text, has_next_page). Line window
        then char pagination, mirroring read_file (toolsService.ts)."""
        p = self.resolve(path)
        if not p.is_file():
            raise FileNotFoundError(f"file does not exist: {path}")
        text = p.read_text(errors="replace")
        if start_line is not None or end_line is not None:
            lines = text.splitlines(keepends=True)
            s = (start_line or 1) - 1
            e = end_line if end_line is not None else len(lines)
            text = "".join(lines[s:e])
        start = (page_number - 1) * MAX_FILE_CHARS_PAGE
        page = text[start:start + MAX_FILE_CHARS_PAGE]
        return page, len(text) > start + MAX_FILE_CHARS_PAGE

    def write_file(self, path: str, content: str) -> Path:
        p = self.resolve(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)
        return p

    def create(self, path: str, *, is_folder: Optional[bool] = None) -> Path:
        # Trailing slash ⇒ folder (prompts.ts create_file_or_folder contract).
        if is_folder is None:
            is_folder = str(path).rstrip().endswith("/")
        p = self.resolve(path)
        if is_folder:
            p.mkdir(parents=True, exist_ok=True)
        else:
            p.parent.mkdir(parents=True, exist_ok=True)
            if not p.exists():
                p.write_text("")
        return p

    def delete(self, path: str, *, is_recursive: bool = False) -> None:
        p = self.resolve(path)
        if p == self.root:
            raise SandboxViolation("refusing to delete sandbox root")
        if p.is_dir():
            if is_recursive:
                shutil.rmtree(p)
            else:
                p.rmdir()
        elif p.exists():
            p.unlink()
        else:
            raise FileNotFoundError(f"path does not exist: {path}")

    # -- listing / tree ----------------------------------------------------
    def ls(self, path: str = "", *, page_number: int = 1
           ) -> Tuple[List[Tuple[str, bool]], bool]:
        """List (name, is_dir) children, paginated at
        MAX_CHILDREN_URIS_PAGE."""
        p = self.resolve(path) if path else self.root
        if not p.is_dir():
            raise NotADirectoryError(f"not a folder: {path}")
        entries = sorted(p.iterdir(),
                         key=lambda c: (not c.is_dir(), c.name.lower()))
        start = (page_number - 1) * MAX_CHILDREN_URIS_PAGE
        window = entries[start:start + MAX_CHILDREN_URIS_PAGE]
        return ([(c.name + ("/" if c.is_dir() else ""), c.is_dir())
                 for c in window],
                len(entries) > start + MAX_CHILDREN_URIS_PAGE)

    def dir_tree(self, path: str = "", *,
                 max_chars: int = DIRECTORY_OPTIMIZATION[
                     "MAX_DIRSTR_CHARS_TOTAL_TOOL"],
                 max_depth: int = DIRECTORY_OPTIMIZATION["MAX_DEPTH"]) -> str:
        """Bounded tree diagram (get_dir_tree / directoryStrService.ts)."""
        p = self.resolve(path) if path else self.root
        lines = [self.display(p) + "/"]
        total = len(lines[0])

        def walk(d: Path, prefix: str, depth: int) -> bool:
            nonlocal total
            if depth > max_depth:
                return True
            try:
                children = sorted(
                    (c for c in d.iterdir() if c.name not in _SKIP_DIRS),
                    key=lambda c: (not c.is_dir(), c.name.lower()))
            except PermissionError:
                return True
            for i, c in enumerate(children):
                connector = "└── " if i == len(children) - 1 else "├── "
                line = prefix + connector + c.name + ("/" if c.is_dir() else "")
                total += len(line) + 1
                if total > max_chars:
                    lines.append(prefix + "… (truncated)")
                    return False
                lines.append(line)
                if c.is_dir():
                    ext = "    " if i == len(children) - 1 else "│   "
                    if not walk(c, prefix + ext, depth + 1):
                        return False
            return True

        walk(p, "", 1)
        return "\n".join(lines)

    # -- search ------------------------------------------------------------
    def _walk_files(self, base: Optional[Path] = None) -> Iterator[Path]:
        base = base or self.root
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for f in filenames:
                yield Path(dirpath) / f

    def search_pathnames(self, query: str, *,
                         include_pattern: Optional[str] = None,
                         page_number: int = 1,
                         page_size: int = MAX_CHILDREN_URIS_PAGE
                         ) -> Tuple[List[str], bool]:
        """Filename substring/glob match (search_pathnames_only)."""
        q = query.lower()
        hits = []
        for f in self._walk_files():
            rel = self.display(f)
            if include_pattern and not fnmatch.fnmatch(rel, include_pattern):
                continue
            if q in rel.lower() or fnmatch.fnmatch(rel.lower(), q):
                hits.append(rel)
        hits.sort()
        start = (page_number - 1) * page_size
        return hits[start:start + page_size], len(hits) > start + page_size

    def search_files(self, query: str, *, is_regex: bool = False,
                     search_in_folder: Optional[str] = None,
                     page_number: int = 1, page_size: int = 50
                     ) -> Tuple[List[str], bool]:
        """Content search returning matching file paths (search_for_files)."""
        base = self.resolve(search_in_folder) if search_in_folder else None
        pat = re.compile(query) if is_regex else None
        hits = []
        for f in self._walk_files(base):
            try:
                text = f.read_text(errors="replace")
            except (OSError, UnicodeError):
                continue
            if (pat.search(text) if pat else query in text):
                hits.append(self.display(f))
        hits.sort()
        start = (page_number - 1) * page_size
        return hits[start:start + page_size], len(hits) > start + page_size

    def search_lines(self, pattern: str, *,
                     base: Optional[str] = None
                     ) -> Iterator[Tuple[str, int, str]]:
        """One-pass workspace grep: yields (display_path, 1-based line,
        line text) for every line matching the regex — each file read
        once, for callers that need all matches across the tree (edit
        prediction) without N separate walks."""
        pat = re.compile(pattern)
        root = self.resolve(base) if base else None
        for f in self._walk_files(root):
            try:
                text = f.read_text(errors="replace")
            except (OSError, UnicodeError):
                continue
            display = self.display(f)
            for i, line in enumerate(text.split("\n"), start=1):
                if pat.search(line):
                    yield display, i, line

    def search_in_file(self, path: str, query: str, *,
                       is_regex: bool = False) -> List[int]:
        """1-based start line numbers where the query matches
        (search_in_file, prompts.ts)."""
        text = self.read_text(path)
        pat = re.compile(query) if is_regex else None
        out = []
        for i, line in enumerate(text.splitlines(), start=1):
            if (pat.search(line) if pat else query in line):
                out.append(i)
        return out
