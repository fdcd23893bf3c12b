"""Paged flash-decode: attention that reads KV through block tables.

The paged engine (rollout/paged_kv.py) stores KV in a fixed pool of
``(block_size, Hkv, D)`` blocks; each token's sequence is a list of
physical block ids. :func:`paged_flash_decode` computes, for every entry
of a flat token batch, Sq=1 attention over its sequence's first
``lengths[t]`` positions, straight from the pool.

Two versions of one function:

* :func:`paged_flash_decode_plain` gathers each entry's blocks into a
  contiguous ``(T, MB*BS, Hkv, D)`` copy and runs ``ops.attention`` over
  it, as ``models/transformer.py::_paged_layer``'s gather branch does.
  The CPU tests and the kernel checks on the card hold the kernel
  against it.
* :func:`paged_flash_decode` launches the hand-written CUDA kernel
  (``csrc/paged_attention.cu``) for CUDA tensors and takes the plain
  version for CPU tensors. A CUDA tensor never falls back: the kernel
  launches or the call raises.

With a bf16 query the kernel splits each entry's positions into chunks
over several blocks and merges their partial softmax states in a second
pass; the chunks come from :func:`flash_decode.split_plan` on the host,
from the shapes alone, so no length is read back from the device. The
optional ``q_tiles`` (built by :func:`query_tiles`) groups consecutive
entries that read the same table row, as the tokens of a chunked-prefill
segment do, so one block reads the segment's prefix once for all of
them. Tiles never change the result.

``lengths[t]`` counts valid positions including the freshly written
current token (write-then-attend). A row with length 0 yields zeros.
With ``k_scale``/``v_scale`` ``(NB, BS, Hkv)`` f32 the pool holds int8
or fp8-e4m3 payloads, dequantized as they are read.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import attention
from .flash_decode import _sm_count, split_plan

_FP8 = torch.float8_e4m3fn
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, _FP8: 3}
_QUANT_DTYPES = (torch.int8, _FP8)
_MAX_HEAD_DIM = 256        # the kernel's register prefetch bound
_MAX_SMEM = 227 * 1024
# Query rows (entries x Hq/Hkv) a tile holds at most: one m16 row block of
# the kernel's mma, whose four warps share each KV tile's positions.
# Measured on the mixed step (PERF.md, on an H100): tiles of up to 64 rows,
# where each warp walked all 64 positions of a KV tile for its own row
# block, took 0.045 ms against 0.033 ms for tiles of 16.
TILE_ROWS = 16
# The CUDA kernels behind paged_flash_decode, for attributing profiler
# time: the split design's two passes and the serial design.
KERNEL_NAMES = ("pfd_split_kernel", "pfd_merge_kernel", "pfd_kernel")


def _tile_cap(rep: int) -> int:
    return max(1, TILE_ROWS // rep)


def query_tiles(seq_row, positions, rep: int) -> torch.Tensor:
    """Query tiles of a flat paged batch, ``(G, 2)`` int32 on the host:
    (first entry, count) of each run of consecutive entries with the same
    table row and consecutive positions (a chunked-prefill segment), cut
    into tiles of at most ``TILE_ROWS // rep`` entries. A decode entry is a
    tile of its own. ``seq_row`` and ``positions`` are host sequences or
    CPU tensors."""
    cap = _tile_cap(rep)

    def ints(x):
        return [int(v) for v in (x.tolist() if torch.is_tensor(x) else x)]
    row, pos = ints(seq_row), ints(positions)
    tiles, start = [], 0
    for i in range(1, len(row) + 1):
        if (i == len(row) or row[i] != row[i - 1]
                or pos[i] != pos[i - 1] + 1 or i - start == cap):
            tiles.append((start, i - start))
            start = i
    return torch.tensor(tiles, dtype=torch.int32).reshape(-1, 2)


def check_query_tiles(q_tiles: torch.Tensor, t: int, rep: int,
                      tables: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError unless ``q_tiles`` (host int32 (G, 2)) covers
    entries 0..t-1 in order with counts of 1..max(1, TILE_ROWS // rep);
    with host ``tables``, also unless each tile's entries share one table
    row."""
    if q_tiles.device.type != "cpu" or q_tiles.dtype != torch.int32 \
            or q_tiles.ndim != 2 or q_tiles.shape[1] != 2:
        raise ValueError(f"q_tiles must be a host int32 (G, 2) tensor, got "
                         f"{q_tiles.dtype} {tuple(q_tiles.shape)} on "
                         f"{q_tiles.device}")
    cap = _tile_cap(rep)
    nxt = 0
    for first, count in q_tiles.tolist():
        if first != nxt:
            raise ValueError(f"q_tiles: tile at entry {first} where entry "
                             f"{nxt} comes next (a gap or an overlap)")
        if not 1 <= count <= cap:
            raise ValueError(f"q_tiles: count {count} at entry {first} is "
                             f"outside 1..{cap} (TILE_ROWS {TILE_ROWS} // "
                             f"rep {rep})")
        if tables is not None and count > 1 and not bool(
                (tables[first:first + count] == tables[first]).all()):
            raise ValueError(f"q_tiles: the tile at entry {first} spans "
                             f"more than one table row")
        nxt = first + count
    if nxt != t:
        raise ValueError(f"q_tiles cover {nxt} entries, the batch has {t}")


def _lengths_vector(lengths, t: int, device) -> torch.Tensor:
    lengths = torch.as_tensor(lengths, device=device)
    return torch.broadcast_to(lengths.to(torch.int32), (t,))


def paged_flash_decode_plain(
    q: torch.Tensor,              # (T, Hq, D)
    k_pool: torch.Tensor,         # (NB, BS, Hkv, D)
    v_pool: torch.Tensor,         # (NB, BS, Hkv, D)
    tables: torch.Tensor,         # (T, MB) physical block per logical block
    lengths,                      # (T,) or scalar: valid positions
    k_scale: Optional[torch.Tensor] = None,   # (NB, BS, Hkv) f32
    v_scale: Optional[torch.Tensor] = None,
    *,
    q_tiles: Optional[torch.Tensor] = None,   # ignored: tiles never
                                              # change the result
) -> torch.Tensor:
    """Gather + ``attention`` reference. Returns (T, Hq, D) in q's dtype.
    Quantized payloads dequantize to q's dtype before attention, as the
    engine's plain branch does."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    t, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = tables.shape[1]
    lengths = _lengths_vector(lengths, t, q.device)
    tbl = tables.long()
    k_seq = k_pool[tbl].reshape(t, mb * bs, hkv, d)
    v_seq = v_pool[tbl].reshape(t, mb * bs, hkv, d)
    if k_scale is not None:
        k_seq = (k_seq.float() * k_scale[tbl].reshape(t, mb * bs, hkv,
                                                      1)).to(q.dtype)
        v_seq = (v_seq.float() * v_scale[tbl].reshape(t, mb * bs, hkv,
                                                      1)).to(q.dtype)
    valid = torch.arange(mb * bs, device=q.device)[None, :] \
        < lengths[:, None]
    out = attention(q[:, None], k_seq.to(q.dtype), v_seq.to(q.dtype),
                    q_offset=lengths.long() - 1, kv_mask=valid,
                    causal=True)[:, 0]
    # The kernels (this port's and the TPU one) return zeros for an
    # empty row; a fully masked softmax would average the dead slots.
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _check(q, k_pool, v_pool, tables, lengths, k_scale, v_scale):
    dev = q.device
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "tables": tables, "lengths": lengths}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.ndim != 3 or k_pool.ndim != 4:
        raise ValueError(f"expected q (T, Hq, D) and pools (NB, BS, Hkv, D), "
                         f"got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    t, hq, d = q.shape
    nb, bs, hkv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q head dim {d}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (f32, bf16)")
    if k_pool.dtype not in _KV_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                         f"supported (f32, bf16, int8, fp8-e4m3)")
    quant = k_pool.dtype in _QUANT_DTYPES
    if quant != (k_scale is not None):
        raise ValueError("int8/fp8 pools need k_scale and v_scale; "
                         "full-width pools take none")
    if quant:
        for x in (k_scale, v_scale):
            if x.dtype != torch.float32 or tuple(x.shape) != (nb, bs, hkv):
                raise ValueError(f"scales must be f32 {(nb, bs, hkv)}, got "
                                 f"{x.dtype} {tuple(x.shape)}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's {_MAX_HEAD_DIM}")
    if (d * k_pool.element_size()) % 16:
        raise ValueError(f"head dim {d} x {k_pool.element_size()} bytes is "
                         f"not a multiple of the 16-byte load")
    if tables.dtype != torch.int32 or tables.ndim != 2 \
            or tables.shape[0] != t:
        raise ValueError(f"tables must be int32 (T={t}, MB), got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (t,):
        raise ValueError(f"lengths must be int32 ({t},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if t > 65535:
        raise ValueError(f"T={t} exceeds the launch grid's y limit")
    return t, hq, d, bs, hkv, tables.shape[1], quant


def paged_flash_decode(
    q: torch.Tensor,              # (T, Hq, D) — one query per token entry
    k_pool: torch.Tensor,         # (NB, BS, Hkv, D) — one layer's pool
    v_pool: torch.Tensor,         # (NB, BS, Hkv, D)
    tables: torch.Tensor,         # (T, MB) int32; dead entries may hold
                                  # any id
    lengths,                      # (T,) int32 (or a scalar)
    k_scale: Optional[torch.Tensor] = None,   # (NB, BS, Hkv) f32 absmax
    v_scale: Optional[torch.Tensor] = None,   # scales for int8/fp8 pools
    *,
    q_tiles: Optional[torch.Tensor] = None,   # (G, 2) int32 query tiles
) -> torch.Tensor:
    """Block-table Sq=1 attention for the flat paged token batch. Returns
    (T, Hq, D) in q's dtype. CUDA tensors launch the kernel (counted in
    ``paged_flash_decode.launches``, one count for both passes) on the
    current stream without synchronising; CPU tensors take
    :func:`paged_flash_decode_plain`.

    ``q_tiles`` (see :func:`query_tiles`) lists (first entry, count)
    tiles of consecutive entries that read the same table row; the kernel
    reads each KV tile once per query tile, through the table row of the
    tile's first entry. A host tensor is checked on every call
    (:func:`check_query_tiles`: its cover and counts, and, where the
    tables are on the host, that a tile's entries share one table row)
    and copied to the card without a sync. A tensor already on the card
    is NOT checked (that would need a sync): it must be one that
    :func:`check_query_tiles` accepts, as ``forward_paged``'s are (built
    by :func:`query_tiles`, moved once for all its layers' calls);
    malformed device tiles make the kernel read and write out of
    bounds."""
    if q.device.type == "cpu":
        if q_tiles is not None:
            check_query_tiles(q_tiles, q.shape[0],
                              q.shape[1] // k_pool.shape[2], tables)
        return paged_flash_decode_plain(q, k_pool, v_pool, tables, lengths,
                                        k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device "
                         f"{q.device}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    lengths = _lengths_vector(lengths, q.shape[0], q.device).contiguous()
    t, hq, d, bs, hkv, mb, quant = _check(q, k_pool, v_pool, tables,
                                          lengths, k_scale, v_scale)
    if q_tiles is not None:
        if q_tiles.device.type == "cpu":
            check_query_tiles(q_tiles, t, hq // hkv)
        elif (q_tiles.device != q.device or q_tiles.dtype != torch.int32
              or q_tiles.ndim != 2 or q_tiles.shape[1] != 2
              or not q_tiles.is_contiguous()):
            raise ValueError(f"q_tiles must be int32 (G, 2), contiguous, on "
                             f"{q.device} or the host; got {q_tiles.dtype} "
                             f"{tuple(q_tiles.shape)} on {q_tiles.device}")
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = _build.library("paged_attention")
    codes = (_Q_CODES[q.dtype], _KV_CODES[k_pool.dtype])
    smem = lib.swi_paged_flash_decode_smem(hq, hkv, d, *codes)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_flash_decode needs {smem} bytes of shared "
                         f"memory at Hq={hq} Hkv={hkv} D={d} BS={bs}; the "
                         f"card gives a block at most {_MAX_SMEM}")
    splits, chunk, scratch, tiles, n_tiles = 0, 0, None, None, t
    if lib.swi_paged_flash_decode_splits(hq, hkv, d, *codes):
        if q_tiles is not None:
            # from pageable memory CUDA stages the source before the
            # call returns, so the host tensor may go at once
            tiles = q_tiles.contiguous().to(q.device, non_blocking=True)
            n_tiles = tiles.shape[0]
        splits, chunk = split_plan(n_tiles, hkv, mb * bs,
                                   _sm_count(q.device))
        # fp32 partials: acc (T, Hq, splits, D), then (m, l) per row
        scratch = torch.empty(t * hq * splits * (d + 2),
                              dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.swi_paged_flash_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), lengths.data_ptr(),
            None if tiles is None else tiles.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            t, n_tiles, hq, hkv, d, bs, mb, splits, chunk, *codes, stream)
    if rc != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed with "
                           f"cudaError {rc}")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def kernel_resources(d: int = 128) -> dict:
    """Registers per thread, dynamic shared bytes and threads per block,
    and resident blocks per SM of the split pass at head dim ``d`` for
    each pool type (``bf16``, ``int8``, ``fp8``), as the card's runtime
    reports them. Needs a CUDA device."""
    lib = _build.library("paged_attention")
    res = {}
    for name, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8),
                        ("fp8", _FP8)):
        out = (ctypes.c_int * 4)()
        rc = lib.swi_paged_flash_decode_occupancy(d, _KV_CODES[dtype], out)
        if rc != 0:
            raise RuntimeError(f"occupancy query for {name} failed with "
                               f"cudaError {rc}")
        res[name] = dict(zip(("registers", "smem_bytes", "threads",
                              "blocks_per_sm"), list(out)))
    return res
