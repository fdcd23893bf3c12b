"""Conversation checkpoints + before-edit file snapshots.

The reference's two-plane checkpoint system (SURVEY.md §5):
- `browser/fileSnapshotService.ts` (413): capture a file's content before
  the first edit touches it (_ensureFileBeforeStateIsSaved,
  chatThreadService.ts:1062-1068)
- `chatThreadService.ts:1766-2246`: CheckpointEntry records inserted
  before each user turn and at stream end (_addCheckpoint :1766,
  _addUserCheckpoint :2047), with jumpToCheckpointBeforeMessageIdx :2221
  restoring snapshotted files and rewinding the thread; duplicate-insert
  re-check (:1768-1780).

In rollouts this is what makes multi-turn RL episodes resettable: jump
back to any user turn, restore the sandbox files, and branch a new
trajectory from there (e.g. for group sampling in GRPO).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ..agents.llm import ChatMessage
from ..tools.sandbox import Workspace


@dataclasses.dataclass
class DirectorySnapshot:
    """Pre-edit state of a directory: every contained file's content
    (display-path keyed) plus all subdirectory paths (so empty dirs
    survive a rewind too). Distinguishes 'was a directory' from 'did not
    exist' so a rewind across a folder delete restores the folder's
    contents instead of silently dropping them."""
    files: Dict[str, str]
    dirs: List[str] = dataclasses.field(default_factory=list)


# Snapshot value: file content (str), DirectorySnapshot, or None
# ('did not exist').
SnapshotValue = Optional[object]


class FileSnapshotter:
    """Before-edit content capture, keyed by (checkpoint epoch, path)."""

    def __init__(self, workspace: Workspace):
        self.workspace = workspace
        self._current: Dict[str, SnapshotValue] = {}

    def ensure_before_state(self, path: str) -> None:
        """Record the path's pre-edit state once per checkpoint window
        (str = file content, DirectorySnapshot = dir contents, None = did
        not exist)."""
        p = self.workspace.resolve(path)
        key = self.workspace.display(p)
        if key in self._current:
            return
        if p.is_dir():
            files: Dict[str, str] = {}
            dirs: List[str] = []
            for f in sorted(p.rglob("*")):
                if f.is_file():
                    files[self.workspace.display(f)] = f.read_text(
                        errors="replace")
                elif f.is_dir():
                    dirs.append(self.workspace.display(f))
            self._current[key] = DirectorySnapshot(files=files, dirs=dirs)
        elif p.is_file():
            self._current[key] = p.read_text(errors="replace")
        else:
            self._current[key] = None

    def drain(self) -> Dict[str, SnapshotValue]:
        """Hand the window's snapshots to a checkpoint and reset."""
        out = self._current
        self._current = {}
        return out


@dataclasses.dataclass
class CheckpointEntry:
    """CheckpointEntry (chatThreadService.ts checkpoint messages)."""
    checkpoint_id: int
    before_message_idx: int
    kind: str                       # 'user_turn' | 'stream_end'
    files_before: Dict[str, SnapshotValue]
    created_at: float = dataclasses.field(default_factory=time.time)


class ConversationCheckpoints:
    """Checkpoint ledger for one thread + its sandbox."""

    def __init__(self, workspace: Workspace):
        self.workspace = workspace
        self.snapshotter = FileSnapshotter(workspace)
        self.entries: List[CheckpointEntry] = []
        self._next_id = 1

    def add_checkpoint(self, before_message_idx: int,
                       kind: str = "user_turn") -> Optional[CheckpointEntry]:
        """Insert a checkpoint; duplicate-guard mirrors the reference's
        re-check (:1768-1780): one checkpoint per message index + kind."""
        for e in self.entries:
            if e.before_message_idx == before_message_idx and e.kind == kind:
                return None
        entry = CheckpointEntry(
            checkpoint_id=self._next_id,
            before_message_idx=before_message_idx, kind=kind,
            files_before=self.snapshotter.drain())
        self._next_id += 1
        self.entries.append(entry)
        return entry

    def jump_to_before_message(self, message_idx: int,
                               messages: List[ChatMessage]
                               ) -> List[ChatMessage]:
        """jumpToCheckpointBeforeMessageIdx (:2221). A checkpoint's
        files_before holds the pre-states of edits made in the window
        BEFORE it, so rewinding to message M undoes the current
        (un-checkpointed) window first, then every checkpoint strictly
        after M, newest→oldest — the oldest pre-state lands last and
        wins."""
        keep: List[CheckpointEntry] = []
        to_undo: List[CheckpointEntry] = []
        for e in self.entries:
            (keep if e.before_message_idx <= message_idx
             else to_undo).append(e)
        self._restore_files(self.snapshotter.drain())
        for e in sorted(to_undo, key=lambda e: -e.checkpoint_id):
            self._restore_files(e.files_before)
        self.entries = keep
        return messages[:message_idx]

    def _restore_files(self, files: Dict[str, SnapshotValue]) -> None:
        # Each snapshot records the state at its CAPTURE time, not the
        # window start, and a directory snapshot can overlap file
        # snapshots under it. Undo in reverse capture order so
        # earlier-captured (closer-to-window-start) states land last and
        # win — e.g. edit b.txt then delete its folder: the folder
        # restore rewrites the mid-window b.txt, then the older file
        # snapshot puts the original back.
        for path, content in reversed(list(files.items())):
            if content is None:
                try:
                    self.workspace.delete(path, is_recursive=True)
                except FileNotFoundError:
                    pass
            elif isinstance(content, DirectorySnapshot):
                # Recreate the directory exactly: drop whatever stands at
                # the path now, then rebuild subdirs (empty ones too) and
                # rewrite every snapshotted file.
                try:
                    self.workspace.delete(path, is_recursive=True)
                except FileNotFoundError:
                    pass
                self.workspace.create(path + "/")
                for d in content.dirs:
                    self.workspace.create(d + "/")
                for fpath, fcontent in content.files.items():
                    self.workspace.write_file(fpath, fcontent)
            else:
                self.workspace.write_file(path, content)
