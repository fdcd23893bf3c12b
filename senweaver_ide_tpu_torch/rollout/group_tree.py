"""Group-shared and tree-structured rollout planning.

A GRPO group of G completions shares one prompt, so it should pay ONE
prefill, not G. The paged allocator already has the primitives —
``fork()`` refcount grafts and ``cow_target()`` boundary-block
copy-on-write — and the engine's ``submit_group`` wires them into the
decode path: the first member (the donor) prefills normally; on
completion the engine captures a pure-prompt fork of its block table
and every follower grafts it with a refcount bump plus a one-token
dropped-write rescore. The whole group then decodes as ordinary rows
of the ONE fused jitted paged step — sharing adds zero jit signatures
and zero extra host syncs.

:class:`GroupRollout` generalizes the group to a TREE. A
:class:`BranchPolicy` watches each leaf's emitted stream and splits it
mid-trajectory — at tool-call boundary tokens, or where the sampled
token's behavior log-prob drops below a threshold (high entropy =
genuinely contested continuations, which the GRPO credit-assignment
analysis says is exactly where per-token credit is sharpest). A split
is ``engine.fork_request``: the child shares the parent's whole KV
spine copy-on-write, so N leaves cost one prefill plus only the
divergent suffixes' decode.

Exactness contract (the spine of the design, tested in
``tests/test_group_tree.py``): every leaf's greedy output is
bitwise-identical to an unshared, independently-prefilled decode of
the same stream — at every branch depth, with speculation on or off,
and under an active LoRA adapter. Sharing is a pure cost optimization;
it is never allowed to change a token.

The planner is pure host orchestration: it calls ``engine.step()``
(which performs the step's single batched device→host transfer) and
reads host-side emissions — no device work, no extra syncs, listed in
jit-lint's HOT_MODULES to keep it that way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import get_registry

# Tree depth histogram buckets: depth is a small integer; bucket edges
# at each depth keep the histogram exact up to 8 and lump the tail.
_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0)


@dataclasses.dataclass(frozen=True)
class BranchPolicy:
    """When and how a leaf splits. All triggers are evaluated on HOST
    emissions after each engine step, so branching never touches the
    jitted path.

    A branch event fires at an emitted token when

    * the token is in ``branch_tokens`` (tool-call boundaries), or
    * its behavior log-prob ≤ ``logp_threshold`` (high-entropy split);

    subject to the structural guards: tree-wide ``max_leaves``, per-leaf
    ``max_depth``, and ``min_tokens_between`` emitted tokens since the
    leaf's last branch point. Speculation can emit several tokens per
    step; the split lands at the leaf's CURRENT position (the step
    boundary after the trigger), which the recorded ``branch_pos``
    reflects honestly.

    At an event the leaf stays live and spawns either one forced child
    per token in ``forced_tokens`` (each child explores that token in
    place of the parent's last sampled one) or ``branch_width - 1``
    sampled children (which adopt the parent's last token and diverge
    by sampling — identical under greedy, exploratory under
    temperature)."""

    max_leaves: int = 8
    max_depth: int = 2
    branch_width: int = 2
    min_tokens_between: int = 8
    branch_tokens: Tuple[int, ...] = ()
    logp_threshold: Optional[float] = None
    forced_tokens: Tuple[int, ...] = ()

    def should_branch(self, token: int, logp: float) -> bool:
        if token in self.branch_tokens:
            return True
        return (self.logp_threshold is not None
                and logp <= self.logp_threshold)


@dataclasses.dataclass
class Leaf:
    """One node of the rollout tree (host bookkeeping only).

    ``inherited`` is the group-relative response prefix this leaf took
    over from its ancestors — its engine request's own ``tokens`` only
    cover the suffix after the fork. ``response()`` splices the two, so
    every leaf reads as a full completion of the ORIGINAL group prompt
    regardless of where in the tree it grew."""

    rid: int
    gid: int
    depth: int = 0
    parent_rid: Optional[int] = None
    branch_pos: Optional[int] = None      # group-relative fork position
    forced_token: Optional[int] = None
    inherited: List[int] = dataclasses.field(default_factory=list)
    inherited_logps: List[float] = dataclasses.field(default_factory=list)
    # group-relative positions where this leaf's PATH branched: where it
    # split from its parent and where children split off of it — the
    # diagnostics head scores token-level credit at exactly these.
    branch_points: List[int] = dataclasses.field(default_factory=list)
    last_branch: int = 0                  # emitted count at last split
    done: bool = False


class GroupRollout:
    """Tree-structured shared-KV rollout planner over one engine.

    Usage::

        gr = GroupRollout(engine, policy=BranchPolicy(...))
        gid = gr.submit_group(prompt, group_size=8, max_new_tokens=64)
        gr.run()                      # drives engine.step() to drain
        leaves = gr.collect(gid)      # full per-leaf trajectories

    One planner can hold many concurrent groups; they all share the
    engine's continuous batch. ``collect`` returns one record per leaf
    with the spliced full response, behavior logps, lineage, and
    branch-point metadata for GRPO credit assignment."""

    def __init__(self, engine, policy: Optional[BranchPolicy] = None):
        self.engine = engine
        self.policy = policy or BranchPolicy()
        self._leaves: Dict[int, Leaf] = {}          # rid -> leaf
        self._groups: Dict[int, List[int]] = {}     # gid -> rids
        self._budgets: Dict[int, int] = {}          # gid -> max_new
        self._next_gid = 0
        self._last_stats: Dict[str, int] = {}
        reg = get_registry()
        self._m_prefills = reg.counter(
            "senweaver_rollout_group_prefills_total",
            "Shared prompt prefills executed for rollout groups (one "
            "per non-degraded group, regardless of group size).")
        self._m_forks = reg.counter(
            "senweaver_rollout_group_forks_total",
            "Block-table forks taken by group followers and tree "
            "branches (refcount bumps — zero KV bytes moved).")
        self._m_cow = reg.counter(
            "senweaver_rollout_group_cow_copies_total",
            "Copy-on-write block splits triggered while group/tree "
            "rollouts were in flight.")
        self._m_avoided = reg.counter(
            "senweaver_rollout_group_prefill_tokens_avoided_total",
            "Prompt tokens NOT re-prefilled thanks to spine sharing "
            "(followers and branches).")
        self._m_branches = reg.counter(
            "senweaver_rollout_group_branch_events_total",
            "BranchPolicy split events (each spawns >= 1 child leaf).")
        self._m_degrades = reg.counter(
            "senweaver_rollout_group_degrades_total",
            "Groups whose donor died before spine capture — followers "
            "fell back to unshared prefills (slower, never inexact).")
        self._h_depth = reg.histogram(
            "senweaver_rollout_group_tree_depth",
            "Tree depth of finished leaves (0 = unbranched root).",
            buckets=_DEPTH_BUCKETS)

    # -- submission ---------------------------------------------------------

    def submit_group(self, prompt: Sequence[int], group_size: int, *,
                     max_new_tokens: int = 128,
                     eos_id: Optional[int] = None,
                     adapter_id: Optional[str] = None) -> int:
        """Submit one GRPO group through the shared-prefill path and
        register its members as depth-0 tree leaves. Returns a planner
        group id for :meth:`collect`."""
        self._snapshot_stats()
        rids = self.engine.submit_group(
            list(prompt), group_size, max_new_tokens=max_new_tokens,
            eos_id=eos_id, adapter_id=adapter_id)
        gid = self._next_gid
        self._next_gid += 1
        self._groups[gid] = list(rids)
        self._budgets[gid] = int(max_new_tokens)
        for rid in rids:
            self._leaves[rid] = Leaf(rid=rid, gid=gid)
        return gid

    # -- driving ------------------------------------------------------------

    def step(self) -> Dict[int, List[int]]:
        """One engine step plus branch-policy evaluation on whatever it
        emitted. Returns the engine's raw {rid: [tokens]} emissions."""
        emitted = self.engine.step()
        self._apply_policy(emitted)
        self._fold_stats()
        return emitted

    def run(self) -> None:
        """Drive until every leaf (including ones spawned mid-run)
        finishes."""
        while self.engine.has_work:
            self.step()
        for leaf in self._leaves.values():
            self._mark_done(leaf)

    # -- branching ----------------------------------------------------------

    def _apply_policy(self, emitted: Dict[int, List[int]]) -> None:
        pol = self.policy
        for rid, toks in emitted.items():
            leaf = self._leaves.get(rid)
            if leaf is None or leaf.done or not toks:
                continue
            if self.engine.is_done(rid):
                self._mark_done(leaf)
                continue
            if (pol.max_depth <= leaf.depth
                    or len(self._group_leaves(leaf.gid))
                    >= pol.max_leaves):
                continue
            own = self.engine.result(rid)
            logps = self.engine.result_logps(rid)
            n = len(own)
            # evaluate only this step's emissions; a burst (speculation)
            # fires at most one event, at the step boundary
            trigger = False
            for i in range(n - len(toks), n):
                if pol.should_branch(own[i], logps[i]):
                    trigger = True
                    break
            if not trigger or n - leaf.last_branch < pol.min_tokens_between:
                continue
            self._branch(leaf, own, logps)

    def _branch(self, leaf: Leaf, own: List[int],
                logps: List[float]) -> None:
        pol = self.policy
        pos = len(leaf.inherited) + len(own)    # group-relative
        budget = self._budgets.get(leaf.gid, 128)
        room = max(1, budget - (pos - 1))
        specs: List[Optional[int]]
        if pol.forced_tokens:
            specs = [int(t) for t in pol.forced_tokens]
        else:
            specs = [None] * max(1, pol.branch_width - 1)
        spawned = 0
        for forced in specs:
            if len(self._group_leaves(leaf.gid)) >= pol.max_leaves:
                break
            try:
                crid = self.engine.fork_request(
                    leaf.rid, token=forced, max_new_tokens=room)
            except (KeyError, ValueError):
                break       # parent finished/preempted under us
            inherited = leaf.inherited + own[:-1]
            inh_logps = leaf.inherited_logps + logps[:-1]
            if forced is not None:
                # the forced token replaces the parent's last sampled
                # one; it was never sampled, so its behavior logp is a
                # pinned 0.0 — trajectory consumers mask it via
                # branch_points metadata
                inherited = inherited + [int(forced)]
                inh_logps = inh_logps + [0.0]
            child = Leaf(
                rid=crid, gid=leaf.gid, depth=leaf.depth + 1,
                parent_rid=leaf.rid, branch_pos=pos,
                forced_token=forced,
                inherited=inherited, inherited_logps=inh_logps,
                branch_points=leaf.branch_points + [pos],
                last_branch=len(own))
            self._leaves[crid] = child
            self._groups[leaf.gid].append(crid)
            spawned += 1
        if spawned:
            leaf.branch_points.append(pos)
            leaf.last_branch = len(own)
            self._m_branches.inc()

    # -- results ------------------------------------------------------------

    def response(self, rid: int) -> List[int]:
        """The leaf's FULL group-relative response: ancestor-inherited
        prefix + its own engine-emitted suffix."""
        leaf = self._leaves[rid]
        return list(leaf.inherited) + self.engine.result(rid)

    def response_logps(self, rid: int) -> List[float]:
        leaf = self._leaves[rid]
        return (list(leaf.inherited_logps)
                + self.engine.result_logps(rid))

    def collect(self, gid: int) -> List[Dict[str, object]]:
        """Per-leaf trajectory records for one group, donor-rooted
        leaves first (stable submit/spawn order). Each record carries
        the branch-point metadata the diagnostics head scores
        token-level credit at."""
        out = []
        for rid in self._groups.get(gid, []):
            leaf = self._leaves[rid]
            self._mark_done(leaf)
            out.append({
                "rid": rid,
                "parent_rid": leaf.parent_rid,
                "depth": leaf.depth,
                "branch_pos": leaf.branch_pos,
                "forced_token": leaf.forced_token,
                "branch_points": list(leaf.branch_points),
                "tokens": self.response(rid),
                "logps": self.response_logps(rid),
            })
        return out

    def branch_stats(self) -> Dict[str, int]:
        """Planner-level tree shape summary (folded into GRPO round
        health by training/rl_loop.py)."""
        leaves = list(self._leaves.values())
        return {
            "groups": len(self._groups),
            "leaves": len(leaves),
            "branched_leaves": sum(1 for l in leaves if l.depth > 0),
            "branch_events": sum(
                1 for l in leaves for p in l.branch_points
                if not l.branch_pos or p > l.branch_pos),
            "max_depth": max((l.depth for l in leaves), default=0),
        }

    # -- internals ----------------------------------------------------------

    def _group_leaves(self, gid: int) -> List[int]:
        return self._groups.get(gid, [])

    def _mark_done(self, leaf: Leaf) -> None:
        if leaf.done or not self.engine.is_done(leaf.rid):
            return
        leaf.done = True
        self._h_depth.observe(float(leaf.depth))

    def _snapshot_stats(self) -> None:
        if not self._last_stats:
            self._last_stats = self.engine.stats()

    def _fold_stats(self) -> None:
        """Mirror the engine's group/branch counter MOVEMENT into the
        ``senweaver_rollout_group_*`` series — deltas, so standalone
        engine users and multiple planners never double-count."""
        cur = self.engine.stats()
        prev = self._last_stats or {}

        def delta(key: str) -> int:
            return max(0, int(cur.get(key, 0)) - int(prev.get(key, 0)))

        self._m_prefills.inc(delta("group_prefills"))
        self._m_forks.inc(delta("group_forks") + delta("branch_forks"))
        self._m_avoided.inc(delta("group_prefill_tokens_avoided"))
        self._m_degrades.inc(delta("group_degrades"))
        self._m_cow.inc(delta("kv_cow_copies"))
        self._last_stats = cur
