"""Speculative decoding: draft-model proposals, one-forward verification.

A small draft model proposes ``k`` tokens autoregressively, the big
target model scores all of them in a SINGLE forward, and the standard
rejection rule (Leviathan et al. 2023) keeps the longest valid prefix,
so the target's cost per emitted token drops toward 1/k of a per-token
loop while the output distribution is exactly the target's.

Greedy (temperature 0) acceptance is ``proposal == target argmax``,
which makes the output IDENTICAL to vanilla greedy decoding of the
target, the property the tests pin on the fp32 test config (a (1, k)
verify forward and a (1, 1) decode step may round differently in bf16,
which can flip a near-tie argmax). Stochastic sampling uses the exact
accept-with-prob(min(1, p/q)) rule with residual resampling on
rejection, which preserves the target distribution. Its randomness
comes from a numpy ``Generator`` where the JAX version takes a key.

Cache bookkeeping: both models keep a "pending" token (emitted but not
yet written to cache). Each round feeds ``[pending, d_1..d_{k-1}]`` so
position i's logits are the target distribution FOR proposal d_{i+1};
on acceptance of m ≤ k proposals both caches truncate to the valid
prefix (the slot cache by resetting ``length``, the paged cache by
releasing the blocks past it).

Single-sequence (B=1): per-sequence acceptance lengths make batched
caches ragged; the engine's fused speculation covers the batched case.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import (KVCache, Params, forward, forward_paged,
                                  init_kv_cache)
from ..obs.runtime_profile import ProfiledFunction
from .paged_kv import PagedKVPool, PagedSeqKV


@torch.no_grad()
def _verify_forward(params: Params, config: ModelConfig,
                    tokens: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Feed (1, k) tokens; return fp32 logits (k, V) + updated cache (its
    tensors written in place)."""
    logits, cache = forward(params, config, tokens, cache=cache)
    return logits[0], cache


@torch.no_grad()
def _verify_forward_paged(params: Params, config: ModelConfig,
                          tokens: torch.Tensor, tables: torch.Tensor,
                          positions: torch.Tensor,
                          write_block: torch.Tensor,
                          write_off: torch.Tensor, pool: PagedKVPool,
                          last_only: bool):
    """Paged verify: feed (k,) tokens of one sequence through the
    block-table forward (K1 in query tiles on the card). ``last_only``
    keeps the final row only (prefill). The pool's tensors are written
    in place, whatever its ladder rung."""
    logits, pool = forward_paged(
        params, config, tokens, pool=pool, tables=tables,
        seq_row=torch.zeros(positions.shape[0], dtype=torch.int64),
        positions=positions, write_block=write_block, write_off=write_off,
        use_kernel=pool.k.device.type == "cuda")
    if last_only:
        logits = logits[-1:]
    return logits, pool


# Runtime observatory wiring (obs/runtime_profile.py): the verify
# forwards are the speculative hot path, under the JAX package's names.
_verify_forward = ProfiledFunction(
    _verify_forward, "speculative.verify", skip_args=(0, 1))
_verify_forward_paged = ProfiledFunction(
    _verify_forward_paged, "speculative.verify_paged", skip_args=(0, 1),
    storm_threshold=32)


def _truncate(cache: KVCache, length: int) -> KVCache:
    """Roll the cache back to ``length`` valid tokens (pure metadata:
    stale entries past length are masked out of attention)."""
    return cache._replace(length=torch.tensor(
        length, dtype=torch.int32, device=cache.length.device))


def _softmax(logits: np.ndarray, temperature: float) -> np.ndarray:
    x = logits.astype(np.float64) / max(temperature, 1e-6)
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


class SpeculativeDecoder:
    """Draft/target pair with independent KV caches on the params'
    device."""

    def __init__(self, target_params: Params, target_config: ModelConfig,
                 draft_params: Params, draft_config: ModelConfig, *,
                 k: int = 4, kv_layout: str = "slots",
                 block_size: int = 16, kv_dtype: str = "bf16"):
        if target_config.vocab_size != draft_config.vocab_size:
            raise ValueError(
                "draft and target must share a vocabulary "
                f"({draft_config.vocab_size} vs {target_config.vocab_size})")
        if (target_config.sliding_window is not None
                or draft_config.sliding_window is not None):
            # Rollback relies on stale entries past `length` being
            # masked, but a ring cache physically OVERWRITES slot
            # pos % cap: rejected draft writes destroy in-window keys and
            # cannot be undone by resetting length.
            raise ValueError(
                "speculative decoding does not support sliding-window "
                "(ring-cache) configs: draft rejection cannot roll back "
                "overwritten ring slots — use sampler.generate instead")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if kv_layout not in ("slots", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.tp, self.tc = target_params, target_config
        self.dp, self.dc = draft_params, draft_config
        self.k = k
        # "paged" verifies through block tables: rejection releases the
        # rejected drafts' blocks instead of only resetting a length;
        # _last_paged_kv exposes the (target, draft) caches so tests can
        # assert no block leaks.
        self.kv_layout = kv_layout
        self.block_size = block_size
        # The quantized KV ladder applies to the TARGET cache only (paged
        # layout): acceptance compares the target's argmax against the
        # proposals, so the exactness budget is the target's; the draft
        # cache stays full width.
        if kv_dtype != "bf16" and kv_layout != "paged":
            raise ValueError("kv_dtype quantized ladder needs "
                             "kv_layout='paged'")
        self.kv_dtype = kv_dtype
        self._last_paged_kv: Optional[Tuple[PagedSeqKV, PagedSeqKV]] = None
        self.rounds = 0          # verify forwards run (observability)
        self.accepted = 0        # proposals accepted across rounds
        self.proposed = 0

    def generate(self, prompt: List[int], *, max_new_tokens: int,
                 temperature: float = 0.0,
                 eos_id: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None,
                 max_len: Optional[int] = None) -> List[int]:
        """Decode ``max_new_tokens`` tokens (stops early at ``eos_id``).
        ``rng`` drives the stochastic path (default: seed 0, as the JAX
        version's default key)."""
        k = self.k
        rng = np.random.default_rng(0) if rng is None else rng
        dev = self.tp["embed"].device
        n_prompt = len(prompt)
        # Each verify round writes up to k tokens past the accepted prefix
        # before truncation: enforce that headroom on top of any
        # caller-supplied max_len.
        max_len = max(max_len or 0, n_prompt + max_new_tokens + k + 1)
        paged = self.kv_layout == "paged"
        greedy = temperature <= 0.0
        if paged:
            t_kv = PagedSeqKV(self.tc, max_len=max_len,
                              block_size=self.block_size,
                              kv_dtype=self.kv_dtype, device=dev)
            d_kv = PagedSeqKV(self.dc, max_len=max_len,
                              block_size=self.block_size, device=dev)
            self._last_paged_kv = (t_kv, d_kv)
            t_cache = d_cache = None
            t_last = self._paged_feed(t_kv, self.tp, self.tc, prompt,
                                      last_only=True)
            self._paged_feed(d_kv, self.dp, self.dc, prompt,
                             last_only=True)
        else:
            from .sampler import prefill
            t_cache = init_kv_cache(self.tc, 1, max_len, device=dev)
            d_cache = init_kv_cache(self.dc, 1, max_len, device=dev)
            toks = torch.tensor([prompt], dtype=torch.int64, device=dev)
            t_last, t_cache = prefill(self.tp, self.tc, toks, t_cache)
            _d_last, d_cache = prefill(self.dp, self.dc, toks, d_cache)
        # pending = emitted-but-uncached; its target dist is in hand
        pending = (int(torch.argmax(t_last[0])) if greedy
                   else self._pick(t_last[0].float().cpu().numpy(),
                                   temperature, rng))
        out = [pending]
        n_cached = n_prompt

        while len(out) < max_new_tokens and \
                (eos_id is None or out[-1] != eos_id):
            # -- draft k proposals ----------------------------------------
            # Feed pending, then each proposal; the k-th proposal is
            # picked from the final dist but never fed, keeping draft and
            # target caches in lockstep at [pending, d_1..d_{k-1}]. Greedy
            # proposals stay on the device (each argmax feeds the next
            # step) and come to the host once, after the loop.
            q_logits: List[np.ndarray] = []
            props_dev: List[torch.Tensor] = []
            proposals: List[int] = []
            tok = torch.tensor([pending], dtype=torch.int64, device=dev)
            for _ in range(k):
                if paged:
                    dl = self._paged_feed(d_kv, self.dp, self.dc, tok)
                else:
                    dl, d_cache = _verify_forward(self.dp, self.dc,
                                                  tok[None, :], d_cache)
                if greedy:
                    tok = torch.argmax(dl[-1:], dim=-1)
                    props_dev.append(tok)
                else:
                    q_logits.append(dl[-1].float().cpu().numpy())
                    proposals.append(self._pick(q_logits[-1], temperature,
                                                rng))
                    tok = torch.tensor([proposals[-1]], dtype=torch.int64,
                                       device=dev)
            if greedy:
                proposals = [int(x) for x in torch.cat(props_dev).tolist()]

            # -- verify in ONE target forward ------------------------------
            feed = [pending] + proposals[:-1]
            if paged:
                p_dev = self._paged_feed(t_kv, self.tp, self.tc, feed)
            else:
                p_dev, t_cache = _verify_forward(
                    self.tp, self.tc,
                    torch.tensor([feed], dtype=torch.int64, device=dev),
                    t_cache)
            self.rounds += 1
            self.proposed += k

            # -- acceptance --------------------------------------------------
            m = 0
            correction: Optional[int] = None
            if greedy:
                t_arg = torch.argmax(p_dev, dim=-1).tolist()   # (k,) ints
                for i, d_i in enumerate(proposals):
                    if int(t_arg[i]) != d_i:
                        correction = int(t_arg[i])
                        break
                    m += 1
            else:
                p_logits = p_dev.float().cpu().numpy()   # row i: prop i
                for i, d_i in enumerate(proposals):
                    p = _softmax(p_logits[i], temperature)
                    q = _softmax(q_logits[i], temperature)
                    if rng.random() >= min(1.0,
                                           p[d_i] / max(q[d_i], 1e-12)):
                        residual = np.maximum(p - q, 0.0)
                        total = residual.sum()
                        if total <= 0:
                            correction = int(rng.choice(len(p), p=p))
                        else:
                            correction = int(rng.choice(
                                len(residual), p=residual / total))
                        break
                    m += 1
            self.accepted += m

            if m == k:
                emitted = proposals
                new_pending = proposals[-1]
                # caches hold pending + proposals[:-1] = 1 + (k-1) tokens
                n_cached += k
            else:
                emitted = proposals[:m] + [correction]
                new_pending = correction
                n_cached += 1 + m            # pending + accepted prefix
                if paged:
                    # the rejected drafts' blocks go back to the pool
                    t_kv.truncate(n_cached)
                    d_kv.truncate(n_cached)
                else:
                    t_cache = _truncate(t_cache, n_cached)
                    d_cache = _truncate(d_cache, n_cached)

            for tok_i in emitted:
                out.append(int(tok_i))
                if eos_id is not None and tok_i == eos_id:
                    break
                if len(out) >= max_new_tokens:
                    break
            pending = new_pending

        return out[:max_new_tokens]

    def _paged_feed(self, kv: PagedSeqKV, params: Params,
                    config: ModelConfig, toks, *,
                    last_only: bool = False) -> torch.Tensor:
        """Feed tokens (a host list or a device tensor) at the cache tip
        through the block-table forward; returns fp32 logits rows ((1, V)
        when ``last_only``, else (len(toks), V)). Grows the block table
        first so every write lands in an owned block; write blocks and
        positions are computed on the host."""
        n = len(toks)
        start = kv.length
        kv.ensure(start + n)
        bs = kv.allocator.block_size
        poss = list(range(start, start + n))
        if not torch.is_tensor(toks):
            toks = torch.tensor(toks, dtype=torch.int64)
        logits, kv.pool = _verify_forward_paged(
            params, config, toks, kv.tables_array(),
            torch.tensor(poss, dtype=torch.int64),
            torch.tensor([kv.table[p // bs] for p in poss],
                         dtype=torch.int64),
            torch.tensor([p % bs for p in poss], dtype=torch.int64),
            kv.pool, last_only)
        kv.length = start + n
        return logits

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @staticmethod
    def _pick(logits: np.ndarray, temperature: float,
              rng: np.random.Generator) -> int:
        if temperature <= 0.0:
            return int(np.argmax(logits))
        p = _softmax(logits, temperature)
        return int(rng.choice(len(p), p=p))


# ---- online draft learning (FastGRPO, PAPERS.md) ------------------------

def _distill_step(params: Params, opt_state, config: ModelConfig,
                  optimizer, tokens: torch.Tensor, mask: torch.Tensor):
    """One cross-entropy step teaching the draft to imitate sequences the
    TARGET emitted. tokens: (B, S); mask True on positions whose
    next-token prediction should be trained (the emitted continuation).
    ``optimizer`` is the trainer's :class:`AdamW` (optax's ``adam`` when
    unclipped with ``b2=0.999``); params and moments update IN PLACE (the
    JAX version returns new ones). Returns (params, opt_state, loss)."""
    from ..training.grpo import token_logprobs
    from ..training.trainer import flatten_params, unflatten_params

    names, leaves = zip(*flatten_params(params))
    m = mask[:, 1:].float()
    for t in leaves:
        t.requires_grad_(True)
    try:
        logits = forward(params, config, tokens[:, :-1])
        logp = token_logprobs(logits, tokens[:, 1:])
        loss = -(logp * m).sum() / torch.clamp_min(m.sum(), 1.0)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    opt_state = optimizer.update(unflatten_params(zip(names, grads)),
                                 opt_state, params)
    return params, opt_state, loss.detach()


class OnlineDraftLearner:
    """Distill the draft toward the target ONLINE from served outputs.

    FastGRPO's observation (PAPERS.md): during RL the target policy
    drifts, so a frozen draft's acceptance rate (and with it the
    speculative speedup) decays. The fix is continual distillation on
    exactly the sequences the target emits while serving: call
    :meth:`observe` with each finished (prompt, output) pair and
    :meth:`step` between serving bursts. The decoder's draft params are
    replaced at construction by a copy this learner then updates in
    place (the caller's tensors, which may be the target's own, are never
    written), so the next ``generate`` proposes with the improved draft.
    Only the ACCEPTANCE RATE (throughput) moves.
    """

    def __init__(self, decoder: SpeculativeDecoder, *,
                 learning_rate: float = 1e-3, buffer_size: int = 256,
                 max_len: int = 512, pad_id: int = 0, seed: int = 0):
        from ..training.trainer import AdamW, clone_params
        self.decoder = decoder
        decoder.dp = clone_params(decoder.dp)
        # optax.adam(learning_rate): the trainer's Adam, unclipped
        self.optimizer = AdamW(learning_rate=learning_rate,
                               max_grad_norm=None, b2=0.999)
        self.opt_state = self.optimizer.init(decoder.dp)
        self.buffer: List[Tuple[List[int], List[int]]] = []
        self.buffer_size = buffer_size
        self.max_len = max_len
        self.pad_id = pad_id
        self.steps = 0
        self._rng = np.random.default_rng(seed)

    def observe(self, prompt: List[int], output: List[int]) -> None:
        """Record a served sequence (drop-oldest ring buffer)."""
        self.buffer.append((list(prompt), list(output)))
        if len(self.buffer) > self.buffer_size:
            del self.buffer[:len(self.buffer) - self.buffer_size]

    def step(self, batch_size: int = 8) -> float:
        """One distillation update over ``batch_size`` pairs drawn
        uniformly from the buffer. Returns the cross-entropy loss (0.0
        when the buffer is empty)."""
        if not self.buffer:
            return 0.0
        idx = self._rng.choice(len(self.buffer),
                               size=min(batch_size, len(self.buffer)),
                               replace=False)
        pairs = [self.buffer[i] for i in idx]
        # power-of-two width and a constant batch of rows (all-False mask
        # rows), as the JAX version pads for its compile cache: the same
        # batches give the same loss
        width = 16
        need = min(self.max_len,
                   max(len(p) + len(o) for p, o in pairs))
        while width < need:
            width *= 2
        toks = np.full((batch_size, width), self.pad_id, np.int64)
        mask = np.zeros((batch_size, width), bool)
        for i, (p, o) in enumerate(pairs):
            seq = (p + o)[-width:]
            n_out = min(len(o), width)
            toks[i, :len(seq)] = seq
            mask[i, len(seq) - n_out:len(seq)] = True
        dev = self.decoder.dp["embed"].device
        self.decoder.dp, self.opt_state, loss = _distill_step(
            self.decoder.dp, self.opt_state, self.decoder.dc,
            self.optimizer, torch.from_numpy(toks).to(dev),
            torch.from_numpy(mask).to(dev))
        self.steps += 1
        return float(loss)
