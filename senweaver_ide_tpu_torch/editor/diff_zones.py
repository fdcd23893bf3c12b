"""Diff zones: streaming inline-diff state for model-driven edits.

The diff plane of the reference's EditCodeService
(browser/editCodeService.ts:231, types in
common/editCodeServiceTypes.ts): a DiffZone tracks a region's
``originalCode`` while new code streams in, continuously recomputing a
set of line Diffs (edit / insertion / deletion — findDiffs.ts:9), each
individually acceptable or rejectable; accept-all / reject-all resolve a
whole zone. The reference renders these as editor decorations; here the
zone is headless — the same state machine drives rollout tooling and
tests, writing through the Workspace sandbox instead of a text model.

Kept semantics:
- diffs are maximal contiguous changed regions with 1-indexed inclusive
  line ranges; an insertion has an empty original range anchored at
  ``original_start_line`` (end = start - 1), a deletion the mirror
  (findDiffs.ts streak flush)
- accept folds the new lines into ``original_code`` (the diff
  disappears, file untouched); reject splices the original lines back
  into the file (editCodeService.ts acceptOrRejectDiff semantics)
- a snapshot/restore pair mirrors SenweaverFileSnapshot
  (editCodeServiceTypes.ts diffAreaSnapshotKeys + entireFileCode)
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Dict, List, Optional, Tuple

from ..tools.sandbox import Workspace


@dataclasses.dataclass(frozen=True)
class ComputedDiff:
    """One contiguous changed region (editCodeServiceTypes.ts
    ComputedDiff). Ranges are 1-indexed inclusive and ZONE-relative; an
    empty range is encoded as end == start - 1."""
    type: str                  # 'edit' | 'insertion' | 'deletion'
    original_code: str
    original_start_line: int
    original_end_line: int
    code: str
    start_line: int
    end_line: int


@dataclasses.dataclass
class Diff:
    diffid: int
    diffareaid: int
    computed: ComputedDiff


def _pad(s: str) -> List[str]:
    """The padded line space find_diffs numbers its ranges in."""
    return (s + "\n").split("\n")


def _unpad(lines: List[str]) -> str:
    s = "\n".join(lines)
    return s[:-1] if s.endswith("\n") else s


def find_diffs(old: str, new: str) -> List[ComputedDiff]:
    """Line diffs as maximal contiguous changed regions (findDiffs.ts).

    Both inputs get a trailing newline first so ``E`` vs ``E\\n``
    classifies as an insertion, not an edit (findDiffs.ts:12-14).
    """
    old_lines = (old + "\n").split("\n")
    new_lines = (new + "\n").split("\n")
    sm = difflib.SequenceMatcher(a=old_lines, b=new_lines, autojunk=False)
    # merge adjacent non-equal opcodes into one streak, as the reference's
    # +/- streak flushing does
    out: List[ComputedDiff] = []
    streak: Optional[Tuple[int, int, int, int]] = None

    def flush() -> None:
        nonlocal streak
        if streak is None:
            return
        i1, i2, j1, j2 = streak
        streak = None
        if i1 == i2 and j1 == j2:
            return
        if i1 == i2:
            kind = "insertion"
        elif j1 == j2:
            kind = "deletion"
        else:
            kind = "edit"
        out.append(ComputedDiff(
            type=kind,
            original_code="\n".join(old_lines[i1:i2]),
            original_start_line=i1 + 1, original_end_line=i2,
            code="\n".join(new_lines[j1:j2]),
            start_line=j1 + 1, end_line=j2))

    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            flush()
            continue
        if streak is None:
            streak = (i1, i2, j1, j2)
        else:
            streak = (streak[0], i2, streak[2], j2)
    flush()
    return out


@dataclasses.dataclass
class DiffZone:
    """DiffZone (editCodeServiceTypes.ts:84): original code + live diffs
    + stream state for one region of one file."""
    diffareaid: int
    uri: str
    start_line: int            # 1-indexed, in the FILE
    original_code: str
    diff_of_id: Dict[int, Diff] = dataclasses.field(default_factory=dict)
    current_code: str = ""
    is_streaming: bool = True
    stream_line: int = 0       # last zone-relative line touched by stream
    # the file lines the zone currently occupies (start, end) — grows and
    # shrinks as streamed content changes the line count
    file_span: Optional[Tuple[int, int]] = None


class DiffZoneService:
    """Headless EditCodeService: zones, streaming updates, accept/reject."""

    def __init__(self, workspace: Workspace):
        self.workspace = workspace
        self.zone_of_id: Dict[int, DiffZone] = {}
        self._next_zone = 1
        self._next_diff = 1

    # -- zone lifecycle ----------------------------------------------------
    def create_zone(self, uri: str, *, start_line: int = 1,
                    end_line: Optional[int] = None) -> int:
        """Open a streaming DiffZone over file lines
        [start_line, end_line] (default: the whole file).

        A zone always covers ≥1 line ("" is exactly one empty line, the
        ``str.split`` convention) — zero-line zones would make the empty
        string ambiguous between "no lines" and "one blank line"."""
        try:
            text = self.workspace.read_text(uri)
        except FileNotFoundError:
            text = ""
        lines = text.split("\n")
        start_line = max(1, min(start_line, len(lines)))
        if end_line is None:
            end_line = len(lines)
        end_line = max(min(end_line, len(lines)), start_line)
        zone = DiffZone(
            diffareaid=self._next_zone, uri=uri, start_line=start_line,
            original_code="\n".join(lines[start_line - 1:end_line]),
            file_span=(start_line, end_line))
        zone.current_code = zone.original_code
        self._next_zone += 1
        self.zone_of_id[zone.diffareaid] = zone
        return zone.diffareaid

    def write_stream(self, zone_id: int, code_so_far: str) -> List[Diff]:
        """Stream (possibly partial) replacement code into the zone: the
        file gets the new content immediately (as the reference's editor
        does) and the zone's diffs are recomputed against original_code."""
        zone = self._zone(zone_id)
        if not zone.is_streaming:
            raise ValueError(f"zone {zone_id} is not streaming")
        zone.current_code = code_so_far
        zone.stream_line = code_so_far.count("\n") + 1
        self._write_zone(zone)
        return self._recompute(zone)

    def finish_stream(self, zone_id: int) -> List[Diff]:
        zone = self._zone(zone_id)
        zone.is_streaming = False
        zone.stream_line = 0
        diffs = self._recompute(zone)
        if not diffs:
            # empty zones are garbage-collected (editCodeService.ts:350-360)
            del self.zone_of_id[zone_id]
        return diffs

    # -- accept / reject ---------------------------------------------------
    def accept_diff(self, zone_id: int, diffid: int) -> None:
        """Keep the new code: fold the diff's region into original_code so
        it no longer differs. The file is already in the new state."""
        zone, d = self._zone_diff(zone_id, diffid)
        c = d.computed
        # Splice in the same trailing-newline-PADDED space find_diffs
        # computed the line numbers in — a diff touching the synthetic
        # last line (the E vs E\n case) is out of range in unpadded space
        # and would silently no-op, leaving an unresolvable zone.
        orig = _pad(zone.original_code)
        new = _pad(zone.current_code)
        orig[c.original_start_line - 1:c.original_end_line] = \
            new[c.start_line - 1:c.end_line]
        zone.original_code = _unpad(orig)
        self._recompute(zone)
        self._gc(zone)

    def reject_diff(self, zone_id: int, diffid: int) -> None:
        """Revert the diff: splice the original lines back into the file."""
        zone, d = self._zone_diff(zone_id, diffid)
        c = d.computed
        new = _pad(zone.current_code)
        orig = _pad(zone.original_code)
        new[c.start_line - 1:c.end_line] = \
            orig[c.original_start_line - 1:c.original_end_line]
        zone.current_code = _unpad(new)
        self._write_zone(zone)
        self._recompute(zone)
        self._gc(zone)

    def accept_all(self, zone_id: int) -> None:
        zone = self._zone(zone_id)
        zone.original_code = zone.current_code
        zone.diff_of_id.clear()
        self._gc(zone)

    def reject_all(self, zone_id: int) -> None:
        zone = self._zone(zone_id)
        zone.current_code = zone.original_code
        self._write_zone(zone)
        zone.diff_of_id.clear()
        self._gc(zone)

    # -- introspection -----------------------------------------------------
    def diffs_of(self, zone_id: int) -> List[Diff]:
        return list(self._zone(zone_id).diff_of_id.values())

    def zones_of_uri(self, uri: str) -> List[DiffZone]:
        return [z for z in self.zone_of_id.values() if z.uri == uri]

    # -- snapshot / restore (SenweaverFileSnapshot) ------------------------
    def snapshot(self, uri: str) -> Dict:
        return {
            "entire_file_code": self._read(uri),
            "zones": [{
                "diffareaid": z.diffareaid, "start_line": z.start_line,
                "original_code": z.original_code,
                "current_code": z.current_code,
                "is_streaming": z.is_streaming,
                "file_span": list(z.file_span) if z.file_span else None,
            } for z in self.zones_of_uri(uri)],
        }

    def restore(self, uri: str, snap: Dict) -> None:
        self.workspace.write_file(uri, snap["entire_file_code"])
        for z in self.zones_of_uri(uri):
            del self.zone_of_id[z.diffareaid]
        for entry in snap["zones"]:
            span = entry.get("file_span")
            if span is None:
                # the restored file holds current_code, so the occupied
                # span follows ITS line count (not original_code's)
                span = [entry["start_line"],
                        entry["start_line"]
                        + entry["current_code"].count("\n")]
            zone = DiffZone(
                diffareaid=entry["diffareaid"], uri=uri,
                start_line=entry["start_line"],
                original_code=entry["original_code"],
                current_code=entry["current_code"],
                is_streaming=entry["is_streaming"],
                file_span=(span[0], span[1]))
            self.zone_of_id[zone.diffareaid] = zone
            self._next_zone = max(self._next_zone, zone.diffareaid + 1)
            self._recompute(zone)

    # -- internals ---------------------------------------------------------
    def _zone(self, zone_id: int) -> DiffZone:
        zone = self.zone_of_id.get(zone_id)
        if zone is None:
            raise KeyError(f"unknown diff zone: {zone_id}")
        return zone

    def _zone_diff(self, zone_id: int, diffid: int) -> Tuple[DiffZone, Diff]:
        zone = self._zone(zone_id)
        d = zone.diff_of_id.get(diffid)
        if d is None:
            raise KeyError(f"unknown diff {diffid} in zone {zone_id}")
        return zone, d

    def _recompute(self, zone: DiffZone) -> List[Diff]:
        computed = find_diffs(zone.original_code, zone.current_code)
        zone.diff_of_id = {}
        for c in computed:
            d = Diff(diffid=self._next_diff, diffareaid=zone.diffareaid,
                     computed=c)
            self._next_diff += 1
            zone.diff_of_id[d.diffid] = d
        return list(zone.diff_of_id.values())

    def _gc(self, zone: DiffZone) -> None:
        if not zone.is_streaming and not zone.diff_of_id:
            self.zone_of_id.pop(zone.diffareaid, None)

    def _read(self, uri: str) -> str:
        try:
            return self.workspace.read_text(uri)
        except FileNotFoundError:
            return ""

    def _write_zone(self, zone: DiffZone) -> None:
        """Replace the zone's slice of the file with current_code."""
        text = self._read(zone.uri)
        lines = text.split("\n")
        assert zone.file_span is not None   # set at create/restore time
        old_start, old_end = zone.file_span
        new_lines = zone.current_code.split("\n")
        lines[old_start - 1:old_end] = new_lines
        zone.file_span = (old_start, old_start + len(new_lines) - 1)
        self.workspace.write_file(zone.uri, "\n".join(lines))
        # Sibling zones below the edit shift by the line-count delta —
        # without this, a later zone on the same file splices at stale
        # coordinates and clobbers unrelated lines (the reference shifts
        # diffareas on every document change).
        delta = len(new_lines) - (old_end - old_start + 1)
        if delta:
            for other in self.zone_of_id.values():
                if (other is not zone and other.uri == zone.uri
                        and other.file_span is not None
                        and other.file_span[0] > old_end):
                    other.start_line += delta
                    other.file_span = (other.file_span[0] + delta,
                                       other.file_span[1] + delta)
