// Flash attention forward and backward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces, in senweaver_ide_tpu/ops/flash_attention.py, the Pallas TPU
// kernel _fa_kernel (line 48; launched by _fa_forward, line 116, for the
// public flash_attention, line 304) and the blockwise lax.scan backward
// _fa_backward_blockwise (line 177) of its custom VJP _make_flash_fn
// (line 262). Three kernels, each in two instances by operand type:
//
//   forward   out and the logsumexp, online softmax in fp32 over the live
//             KV tiles; bf16: one block per (128-row q tile, q head,
//             batch), f32: per 64-row q tile.
//   dK / dV   bf16: one block per (64-position KV tile, q head, batch)
//             walks the q tiles of its head that see the tile and writes
//             an fp32 partial; a second pass folds each GQA group's rep
//             partials into dK and dV at Hkv heads, in a fixed order (no
//             atomics). f32: one block per (KV tile, KV head, batch) loops
//             over the group itself.
//   dQ        one block per (q tile, q head, batch): loops over the live
//             KV tiles and accumulates dQ = scale * dS K; the block owns
//             its rows (no atomics, no partials).
//
// Semantics are those of the JAX kernel: tensors in the public (B, S, H, D)
// layout, read through their strides (no transpose, no pad copy); a kv_mask
// arrives as an additive fp32 bias (B, Skv); causality and the sliding
// window use absolute positions q_offset + i and kv_offset + j; scores at
// or below MASKED_THRESHOLD count as masked (p = 0); a row with no visible
// key gives out 0 and lse NEG_INF. A ragged S (not a multiple of the tile)
// is masked inside the kernels: rows and columns past the end load as zeros
// and score NEG_INF. Every tile that causality or the window kills on
// either edge is skipped, so the work is the live band of the score matrix.
//
// What bounds it on the H100: the products. At training shapes
// (qwen2.5-coder-1.5b: B=4, S=1023, Hq=12, Hkv=2, D=128) the forward does
// 4*B*Hq*Sq*Skv*D flops, about halved by causality, on ~30 MB of input:
// far above the ~295 flops per byte where the card stops being bound by
// its memory. The backward does 2.5x the forward's products (3.5x here,
// since the dK/dV and dQ kernels each recompute s and dP). So the bf16
// instances, the training path, run on the tensor cores with fp32
// accumulators, the softmax applied to the accumulator registers and P /
// dS reused from them as the next product's A operand (rounded to bf16,
// as SDPA and FlashAttention-2 do), and what keeps the tensor cores
// waiting is what the design works on:
//
//   the ring    K/V (forward, dQ) and Q/dO/lse/delta (dK/dV) tiles stream
//               through two-stage cp.async rings into 128-byte-swizzled
//               shared memory: tile j+1 is copied, without passing
//               through registers, while tile j is multiplied, with one
//               barrier a tile; the tile the block keeps (forward Q, dQ's
//               Q and dO, dK/dV's K and V) is copied once;
//   operands    all three run on wgmma, every shared operand read by a
//               descriptor, so no thread fetches a B operand: the forward
//               S = Q K^T (Q, K K-major) and O += P V (P from registers,
//               V by a transposed MN-major descriptor); dK/dV S^T = K Q^T
//               and dP^T = V dO^T (K-major), then dV += P^T dO and dK +=
//               dS^T Q (P^T, dS^T from registers, dO and Q MN-major); dQ
//               S = Q K^T and dP = dO V^T (K-major), then dQ += dS K (dS
//               from registers, K MN-major, as the forward reads V);
//   masks       the causal, window, ragged and bias tests run only on an
//               edge tile; a tile every row sees whole takes the scaled
//               scores, and p = exp2 of scores pre-scaled by log2(e)/sqrt(D);
//   the grid    1-D, the tile index slowest: the forward's and dQ's
//               heaviest causal q tiles and dK/dV's KV tile 0 (the longest
//               q walk) start first, the light tiles fill the tail; the
//               forward runs two consumer warpgroups over one K/V ring (128
//               q rows a block, two blocks an SM); dK/dV and dQ run one
//               warpgroup a block, two blocks an SM, since each thread
//               holds two score fragments and a (kD)-wide accumulator
//               (dQ: 128 fp32 at D=128) and needs the registers of two
//               warpgroups' worth of the file; dK/dV spreads each GQA group
//               over its rep q heads' blocks, so no block walks more than
//               one head's q tiles.
//
// The f32 instances, which the tests use, keep exact fp32 products on the
// CUDA cores from fp32 tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;          // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;      // finite, as in the reference
constexpr float kMasked = -5e29f;      // NEG_INF * 0.5

struct Dims {
  int b, sq, skv, hq, hkv, d;
  int q_offset, kv_offset;
  int causal, window;  // window <= 0: no sliding window
};

// Element strides of a (B, S, H, D) tensor; the head dim is contiguous.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Stage `rows` rows of kD floats, starting at sequence row `row0` of the
// (already head- and batch-offset) tensor `src`, into the shared tile `dst`
// (row stride kD + 4 floats) with 16-byte loads, multiplied by `mul`. Rows
// at or past `n_valid` are zero.
template <int kD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long row_stride, int row0,
                                      int n_valid, int rows, float mul) {
  constexpr int kVpr = kD / 4;  // float4s per row
  constexpr int kLd = kD + 4;
  for (int i = threadIdx.x; i < rows * kVpr; i += kThreads) {
    const int r = i / kVpr;
    const int c = (i % kVpr) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      f = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c);
      f.x *= mul;
      f.y *= mul;
      f.z *= mul;
      f.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * kLd + c) = f;
  }
}

__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// Max / sum over the 16 lanes that share a score row (lanes 0-15 and 16-31
// of a warp hold two different rows).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Score after bias and masks, for query row qi and key column kj (indices
// within the sequences).
__device__ __forceinline__ float masked_score(float s, const Dims& dm,
                                              const float* bias_row, int qi,
                                              int kj) {
  if (kj >= dm.skv || qi >= dm.sq) return kNegInf;
  if (bias_row != nullptr) s += bias_row[kj];
  if (dm.causal) {
    const int qp = dm.q_offset + qi;
    const int kp = dm.kv_offset + kj;
    bool vis = kp <= qp;
    if (dm.window > 0) vis = vis && (kp > qp - dm.window);
    if (!vis) s = kNegInf;
  }
  return s;
}

// KV tiles [lo, hi) that q rows [q0, q0 + nq) can see.
__device__ __forceinline__ void live_kv_tiles(const Dims& dm, int q0, int nq,
                                              int tk, int* lo, int* hi) {
  *lo = 0;
  *hi = (dm.skv + tk - 1) / tk;
  if (!dm.causal) return;
  const int q_first = dm.q_offset + q0;
  const int q_last = q_first + nq - 1;
  *hi = min(*hi, max(0, floordiv(q_last - dm.kv_offset, tk) + 1));
  if (dm.window > 0)
    *lo = max(0, floordiv(q_first - dm.window + 1 - dm.kv_offset, tk));
}

// -- f32: CUDA cores, exact fp32 products ------------------------------------
//
// Shared memory (fp32, rows padded to kD + 4 so float4 reads of 8
// consecutive rows hit distinct banks; score tiles padded to TK + 16):
//   q_s [TQ][kD+4]   q tile, pre-scaled by 1/sqrt(D)
//   kv_s[TK][kD+4]   the K tile, then the V tile of the same positions
//   p_s [TQ][TK+16]  probabilities of the tile
template <int kD, int NQ, int NK>
__global__ void __launch_bounds__(kThreads, 2)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, float* __restrict__ lse, Dims dm,
              Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  constexpr int TQ = 16 * NQ, TK = 16 * NK, NJ = kD / 64;
  constexpr int kLd = kD + 4, kLd4 = kLd / 4, kPld = TK + 16;
  const int qt = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hk = h / (dm.hq / dm.hkv);

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* kv_s = q_s + TQ * kLd;
  float* p_s = kv_s + TK * kLd;
  const float4* q_s4 = reinterpret_cast<const float4*>(q_s);
  const float4* kv_s4 = reinterpret_cast<const float4*>(kv_s);

  const int q0 = qt * TQ;
  const int nq = min(TQ, dm.sq - q0);
  const float* qb = q + bb * qs.b + h * qs.h;
  const float* kb = k + bb * ks.b + hk * ks.h;
  const float* vb = v + bb * vs.b + hk * vs.h;
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;
  stage<kD>(q_s, qb, qs.s, q0, nq, TQ, scale);

  float m[NQ], l[NQ];
  float4 acc[NQ][NJ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int kt_lo, kt_hi;
  live_kv_tiles(dm, q0, nq, TK, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * TK;
    const int nk = min(TK, dm.skv - k0);
    __syncthreads();  // previous tile's P.V done with kv_s and p_s
    stage<kD>(kv_s, kb, ks.s, k0, nk, TK, 1.f);
    __syncthreads();

    float s[NQ][NK];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < kD / 4; ++d4) {
      float4 qv[NQ], kk[NK];
#pragma unroll
      for (int i = 0; i < NQ; ++i) qv[i] = q_s4[(ty + 16 * i) * kLd4 + d4];
#pragma unroll
      for (int j = 0; j < NK; ++j) kk[j] = kv_s4[(tx + 16 * j) * kLd4 + d4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) s[i][j] = dot4(qv[i], kk[j], s[i][j]);
    }

    // Online softmax, one row per (ty, i), reduced over the 16 tx lanes.
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[i][j] = masked_score(s[i][j], dm, bias_row, qi, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float p = s[i][j] > kMasked ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kPld + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = corr * l[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j].x *= corr;
        acc[i][j].y *= corr;
        acc[i][j].z *= corr;
        acc[i][j].w *= corr;
      }
    }
    __syncthreads();  // K no longer read; p_s complete
    stage<kD>(kv_s, vb, vs.s, k0, nk, TK, 1.f);
    __syncthreads();

    // acc += P V over the tile's positions (rows past nk are zero).
    for (int c = 0; c < nk; ++c) {
      float pr[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) pr[i] = p_s[(ty + 16 * i) * kPld + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 vv = kv_s4[c * kLd4 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NQ; ++i) fma4(acc[i][j], pr[i], vv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= dm.sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    float* orow = out + bb * os.b + static_cast<long long>(qi) * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 a = acc[i][j];
      store4(orow + 4 * (tx + 16 * j),
                     make_float4(a.x / safe_l, a.y / safe_l, a.z / safe_l,
                                 a.w / safe_l));
    }
    if (tx == 0)
      lse[(static_cast<long long>(bb) * dm.hq + h) * dm.sq + qi] =
          l[i] > 0.f ? m[i] + logf(safe_l) : kNegInf;
  }
}

// Shared memory:
//   k_s, v_s   [TK][kD+4]    this block's K and V tile
//   q_s, do_s  [TQ][kD+4]    the current q tile and its dO (unscaled)
//   p_s, ds_s  [TQ][TK+16]   p and dS of the current (q tile, head)
//   lse_s, dl_s[TQ]          the q rows' lse and delta
template <int kD, int NQ, int NK>
__global__ void __launch_bounds__(kThreads, 2)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, Dims dm, Strides qs, Strides ks,
                   Strides vs, Strides dos, Strides dks, Strides dvs,
                   float scale) {
  constexpr int TQ = 16 * NQ, TK = 16 * NK, NJ = kD / 64;
  constexpr int kLd = kD + 4, kLd4 = kLd / 4, kPld = TK + 16;
  const int kt = blockIdx.x, hk = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int rep = dm.hq / dm.hkv;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + TK * kLd;
  float* q_s = v_s + TK * kLd;
  float* do_s = q_s + TQ * kLd;
  float* p_s = do_s + TQ * kLd;
  float* ds_s = p_s + TQ * kPld;
  float* lse_s = ds_s + TQ * kPld;
  float* dl_s = lse_s + TQ;
  const float4* k_s4 = reinterpret_cast<const float4*>(k_s);
  const float4* v_s4 = reinterpret_cast<const float4*>(v_s);
  const float4* q_s4 = reinterpret_cast<const float4*>(q_s);
  const float4* do_s4 = reinterpret_cast<const float4*>(do_s);

  const int k0 = kt * TK;
  const int nk = min(TK, dm.skv - k0);
  stage<kD>(k_s, k + bb * ks.b + hk * ks.h, ks.s, k0, nk, TK, 1.f);
  stage<kD>(v_s, v + bb * vs.b + hk * vs.h, vs.s, k0, nk, TK, 1.f);
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;

  // q tiles [qt_lo, qt_hi) that can see this KV tile
  const int n_qt = (dm.sq + TQ - 1) / TQ;
  int qt_lo = 0, qt_hi = n_qt;
  if (dm.causal) {
    const int k_first = dm.kv_offset + k0;
    const int k_last = k_first + nk - 1;
    qt_lo = max(0, floordiv(k_first - dm.q_offset, TQ));
    if (dm.window > 0)
      qt_hi = min(n_qt,
                  max(0, floordiv(k_last + dm.window - 1 - dm.q_offset, TQ) +
                             1));
  }

  float4 acc_dk[NK][NJ], acc_dv[NK][NJ];
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc_dk[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_dv[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const float* qb = q + bb * qs.b + h * qs.h;
    const float* ob = dout + bb * dos.b + h * dos.h;
    const long long row_base = (static_cast<long long>(bb) * dm.hq + h) *
                               dm.sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * TQ;
      const int nq = min(TQ, dm.sq - q0);
      __syncthreads();  // previous tile's products done with q_s .. ds_s
      stage<kD>(q_s, qb, qs.s, q0, nq, TQ, 1.f);
      stage<kD>(do_s, ob, dos.s, q0, nq, TQ, 1.f);
      for (int i = threadIdx.x; i < TQ; i += kThreads) {
        lse_s[i] = i < nq ? lse[row_base + q0 + i] : 0.f;
        dl_s[i] = i < nq ? delta[row_base + q0 + i] : 0.f;
      }
      __syncthreads();

      // s = Q K^T and dp = dO V^T, rows q (ty + 16 i), columns kv (tx + 16 j)
      float s[NQ][NK], dp[NQ][NK];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d4 = 0; d4 < kD / 4; ++d4) {
        float4 qv[NQ], ov[NQ], kk[NK], vv[NK];
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          qv[i] = q_s4[(ty + 16 * i) * kLd4 + d4];
          ov[i] = do_s4[(ty + 16 * i) * kLd4 + d4];
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          kk[j] = k_s4[(tx + 16 * j) * kLd4 + d4];
          vv[j] = v_s4[(tx + 16 * j) * kLd4 + d4];
        }
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int j = 0; j < NK; ++j) {
            s[i][j] = dot4(qv[i], kk[j], s[i][j]);
            dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const int col = tx + 16 * j;
          const float x = masked_score(s[i][j] * scale, dm, bias_row,
                                       q0 + row, k0 + col);
          const float p = x > kMasked ? expf(x - lse_s[row]) : 0.f;
          p_s[row * kPld + col] = p;
          ds_s[row * kPld + col] = p * (dp[i][j] - dl_s[row]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's q rows; this thread
      // holds kv rows (ty + 16 i) and float4 column groups (tx + 16 j).
      for (int c = 0; c < nq; ++c) {
        float pr[NK], dr[NK];
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          pr[i] = p_s[c * kPld + ty + 16 * i];
          dr[i] = ds_s[c * kPld + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 ov = do_s4[c * kLd4 + tx + 16 * j];
          const float4 qv = q_s4[c * kLd4 + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < NK; ++i) {
            fma4(acc_dv[i][j], pr[i], ov);
            fma4(acc_dk[i][j], dr[i], qv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= dm.skv) continue;
    float* krow = dk + bb * dks.b + static_cast<long long>(kj) * dks.s +
              hk * dks.h;
    float* vrow = dv + bb * dvs.b + static_cast<long long>(kj) * dvs.s +
              hk * dvs.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 a = acc_dk[i][j];
      store4(krow + 4 * (tx + 16 * j),
                     make_float4(a.x * scale, a.y * scale, a.z * scale,
                                 a.w * scale));
      store4(vrow + 4 * (tx + 16 * j), acc_dv[i][j]);
    }
  }
}

// Shared memory:
//   q_s, do_s  [TQ][kD+4]    this block's q tile and its dO
//   k_s, v_s   [TK][kD+4]    the current KV tile
//   ds_s       [TQ][TK+16]   dS of the tile
//   lse_s, dl_s[TQ]
template <int kD, int NQ, int NK>
__global__ void __launch_bounds__(kThreads, 2)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, Dims dm,
                 Strides qs, Strides ks, Strides vs, Strides dos,
                 Strides dqs, float scale) {
  constexpr int TQ = 16 * NQ, TK = 16 * NK, NJ = kD / 64;
  constexpr int kLd = kD + 4, kLd4 = kLd / 4, kPld = TK + 16;
  const int qt = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hk = h / (dm.hq / dm.hkv);

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + TQ * kLd;
  float* k_s = do_s + TQ * kLd;
  float* v_s = k_s + TK * kLd;
  float* ds_s = v_s + TK * kLd;
  float* lse_s = ds_s + TQ * kPld;
  float* dl_s = lse_s + TQ;
  const float4* q_s4 = reinterpret_cast<const float4*>(q_s);
  const float4* do_s4 = reinterpret_cast<const float4*>(do_s);
  const float4* k_s4 = reinterpret_cast<const float4*>(k_s);
  const float4* v_s4 = reinterpret_cast<const float4*>(v_s);

  const int q0 = qt * TQ;
  const int nq = min(TQ, dm.sq - q0);
  const float* kb = k + bb * ks.b + hk * ks.h;
  const float* vb = v + bb * vs.b + hk * vs.h;
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;
  stage<kD>(q_s, q + bb * qs.b + h * qs.h, qs.s, q0, nq, TQ, 1.f);
  stage<kD>(do_s, dout + bb * dos.b + h * dos.h, dos.s, q0, nq, TQ, 1.f);
  const long long row_base = (static_cast<long long>(bb) * dm.hq + h) * dm.sq;
  for (int i = threadIdx.x; i < TQ; i += kThreads) {
    lse_s[i] = i < nq ? lse[row_base + q0 + i] : 0.f;
    dl_s[i] = i < nq ? delta[row_base + q0 + i] : 0.f;
  }

  float4 acc[NQ][NJ];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  int kt_lo, kt_hi;
  live_kv_tiles(dm, q0, nq, TK, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * TK;
    const int nk = min(TK, dm.skv - k0);
    __syncthreads();  // previous tile's dS K done with k_s and ds_s
    stage<kD>(k_s, kb, ks.s, k0, nk, TK, 1.f);
    stage<kD>(v_s, vb, vs.s, k0, nk, TK, 1.f);
    __syncthreads();

    float s[NQ][NK], dp[NQ][NK];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < NK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < kD / 4; ++d4) {
      float4 qv[NQ], ov[NQ], kk[NK], vv[NK];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        qv[i] = q_s4[(ty + 16 * i) * kLd4 + d4];
        ov[i] = do_s4[(ty + 16 * i) * kLd4 + d4];
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        kk[j] = k_s4[(tx + 16 * j) * kLd4 + d4];
        vv[j] = v_s4[(tx + 16 * j) * kLd4 + d4];
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          s[i][j] = dot4(qv[i], kk[j], s[i][j]);
          dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int col = tx + 16 * j;
        const float x = masked_score(s[i][j] * scale, dm, bias_row, q0 + row,
                                     k0 + col);
        const float p = x > kMasked ? expf(x - lse_s[row]) : 0.f;
        ds_s[row * kPld + col] = p * (dp[i][j] - dl_s[row]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's positions
    for (int c = 0; c < nk; ++c) {
      float dr[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) dr[i] = ds_s[(ty + 16 * i) * kPld + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kk = k_s4[c * kLd4 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NQ; ++i) fma4(acc[i][j], dr[i], kk);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= dm.sq) continue;
    float* row = dq + bb * dqs.b + static_cast<long long>(qi) * dqs.s + h * dqs.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 a = acc[i][j];
      store4(row + 4 * (tx + 16 * j),
                     make_float4(a.x * scale, a.y * scale, a.z * scale,
                                 a.w * scale));
    }
  }
}

// -- bf16: the training path, on the tensor cores --------------------------
//
// Fragment layout of the register operands (the mma.sync m16n8k16 layout,
// which wgmma keeps per warp), with g = lane / 4 and t = lane % 4: A (16 x
// 16) regs hold A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// C (16 x 8) holds C[g][2t..2t+1] then C[g+8][2t..2t+1]. The lower index
// sits in the lower 16 bits.

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A masked_score result in the log2 domain: -inf where masked, so that
// ex2(s - m) is 0 there even while the row max m is still kNegInf.
__device__ __forceinline__ float log2_score(float x) {
  return x > kMasked ? x * kLog2e : -__int_as_float(0x7f800000);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not pass through registers;
// `valid` false writes 16 zero bytes (src-size 0, nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pack the C fragments of score n-tiles 2kk and 2kk+1 (16 positions) as the
// A fragment of one k-step (the C -> A reuse of flash attention).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_f2(c0[0], c0[1]);
  a[1] = pack_f2(c0[2], c0[3]);
  a[2] = pack_f2(c1[0], c1[1]);
  a[3] = pack_f2(c1[2], c1[3]);
}

// wgmma (sm_90a): a warpgroup's m64nNk16 product, fp32 accumulators in
// the registers of `d` (d[j][e] is C[16w + g + 8(e / 2)][8j + 2t + e % 2]
// for warp w of the group, the mma.sync C layout per 8-wide n-tile).
// ss: A and B from shared memory by descriptor, scale_d 0 overwrites d;
// rs: A from registers (the mma.sync A layout per warp), B by descriptor,
// transposed (stored MN-major), accumulating.
#define FA_ACC4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC4(d, 0), FA_ACC4(d, 1), FA_ACC4(d, 2),
        FA_ACC4(d, 3), FA_ACC4(d, 4), FA_ACC4(d, 5),
        FA_ACC4(d, 6), FA_ACC4(d, 7)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[8][4],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31},"
      " {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC4(d, 0), FA_ACC4(d, 1), FA_ACC4(d, 2),
        FA_ACC4(d, 3), FA_ACC4(d, 4), FA_ACC4(d, 5),
        FA_ACC4(d, 6), FA_ACC4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[16][4],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63},"
      " {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : FA_ACC4(d, 0), FA_ACC4(d, 1), FA_ACC4(d, 2),
        FA_ACC4(d, 3), FA_ACC4(d, 4), FA_ACC4(d, 5),
        FA_ACC4(d, 6), FA_ACC4(d, 7), FA_ACC4(d, 8),
        FA_ACC4(d, 9), FA_ACC4(d, 10), FA_ACC4(d, 11),
        FA_ACC4(d, 12), FA_ACC4(d, 13), FA_ACC4(d, 14),
        FA_ACC4(d, 15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FA_ACC4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy: each writer fences before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Issue cp.async copies of 64 rows of kD bf16 (row `row0` on, zero-filled
// from `n_valid` on, which may be <= 0) into the 128-byte-swizzled layout the descriptors
// name: kD / 64 column blocks of [64 rows][64 columns], 8 KB each, the
// tile 1024-byte aligned; 16-byte chunk c of row r of a block lands at
// byte r * 128 + ((c ^ r % 8) * 16). K-major for Q and K (the head dim is
// the product's depth), MN-major for V. Every one of the kN threads calls.
template <int kD, int kN>
__device__ __forceinline__ void load_rows_sw128(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride,
                                                int row0, int n_valid) {
  constexpr int kVpr = kD / 8;  // 16-byte chunks per row
  static_assert((64 * kVpr) % kN == 0, "whole chunks per thread");
  char* d = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int j = 0; j < 64 * kVpr / kN; ++j) {
    const int i = threadIdx.x + j * kN;
    const int r = i / kVpr, c = i % kVpr;
    const bool ok = r < n_valid;
    cp_async16(d + (c / 8) * 8192 + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               ok ? src + static_cast<long long>(row0 + r) * row_stride +
                        c * 8
                  : src,
               ok);
  }
}

// O += P V for one 16-position k-step: n = kD.
template <int kD>
__device__ __forceinline__ void wgmma_pv(float (&o)[kD / 8][4],
                                         const uint32_t (&pa)[4],
                                         uint64_t db) {
  if constexpr (kD == 128)
    wgmma_rs_n128_tb(o, pa, db);
  else
    wgmma_rs_n64_tb(o, pa, db);
}

// The forward on Hopper's warpgroup tensor cores. One block per (128-row
// q tile, q head, batch): two consumer warpgroups of 4 warps, warpgroup u
// owning q rows 64u..64u+63 and warp w of it rows 16w..16w+15 of every
// product's accumulator. K/V tiles of 64 positions stream through a
// two-stage cp.async ring into 128-byte-swizzled shared memory, shared by
// both warpgroups: tile j+1 is in flight while tile j is multiplied, one
// barrier a tile. A warpgroup skips the tiles its own rows cannot see.
// Per tile: S = Q K^T as wgmma m64n64k16 with Q and K both read by
// descriptor (kD/16 k-steps); the bias and masks only on an edge tile (see
// below); the online softmax in the log2 domain on the accumulator
// registers (a row's values sit in the 4 lanes of one g, reduced with two
// shuffles); then P, rounded to bf16 and kept in registers as the A
// operand, times V as wgmma m64n(kD)k16 with V read by a transposed
// (MN-major) descriptor.
//
// The grid is 1-D with the q tile slowest and reversed, so the causal
// rows that see the most KV tiles start first and the light ones fill the
// tail.
//
// Shared memory (dynamic, aligned up to 1024 bytes): the two warpgroups'
// Q tiles, then two stages of [K tile][V tile], each 64 x kD bf16 in the
// swizzled layout.
template <int kD>
__global__ void __launch_bounds__(256, 2)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  Dims dm, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale) {
  constexpr int TQ = 64, TK = 64, kTileB = 64 * kD * 2;  // bytes a tile
  constexpr int KK = kD / 16;   // k-steps over the head dim
  constexpr int ND = kD / 8;    // output n-tiles
  constexpr int NS = TK / 8;    // score n-tiles
  const int wg = threadIdx.x / 128;  // this warpgroup's 64 q rows
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (dm.sq + 2 * TQ - 1) / (2 * TQ);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / (dm.hq * dm.b);
  const int h = blockIdx.x % dm.hq, bb = (blockIdx.x / dm.hq) % dm.b;
  const int hk = h / (dm.hq / dm.hkv);

  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t base = (raw + 1023u) & ~1023u;  // tile i at base + i*kTileB
  char* sm = reinterpret_cast<char*>(smem4) + (base - raw);
  auto tile = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(sm + i * kTileB);
  };

  const int qb0 = qt * 2 * TQ;                 // the block's first q row
  const int q0 = qb0 + wg * TQ;                // this warpgroup's
  const int nq = min(TQ, dm.sq - q0);          // <= 0: no rows
  const int r0 = q0 + warp * 16 + g;  // this lane's rows r0 and r0 + 8
  const __nv_bfloat16* qb = q + bb * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + bb * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + bb * vs.b + hk * vs.h;
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;
  const float sl2 = scale * kLog2e;

  // the block walks the KV tiles either warpgroup sees; each computes on
  // its own [kt_lo, kt_hi)
  int kt_lo = 0, kt_hi = 0, bk_lo, bk_hi;
  if (nq > 0) live_kv_tiles(dm, q0, nq, TK, &kt_lo, &kt_hi);
  live_kv_tiles(dm, qb0, min(2 * TQ, dm.sq - qb0), TK, &bk_lo, &bk_hi);
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * TK, nk = min(TK, dm.skv - k0);
    load_rows_sw128<kD, 256>(tile(2 + 2 * stage), kb, ks.s, k0, nk);
    load_rows_sw128<kD, 256>(tile(3 + 2 * stage), vb, vs.s, k0, nk);
  };
  load_rows_sw128<kD, 256>(tile(0), qb, qs.s, qb0, dm.sq - qb0);
  load_rows_sw128<kD, 256>(tile(1), qb, qs.s, qb0 + TQ, dm.sq - qb0 - TQ);
  if (bk_lo < bk_hi) load_kv(bk_lo, 0);
  cp_async_commit();
  const uint32_t q_u = base + wg * kTileB;

  float o[ND][4], s[NS][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  float m0 = kNegInf, m8 = kNegInf, l0 = 0.f, l8 = 0.f;  // m: log2 domain

  for (int kt = bk_lo; kt < bk_hi; ++kt) {
    const int stage = (kt - bk_lo) & 1;
    cp_async_wait_all();  // tile kt has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();      // ... everyone's; and tile kt-1 is done with
    if (kt + 1 < bk_hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    if (kt < kt_lo || kt >= kt_hi) continue;  // warpgroup-uniform
    const uint32_t k_u = base + (2 + 2 * stage) * kTileB;
    const uint32_t v_u = k_u + kTileB;
    const int k0 = kt * TK;

    // S = Q K^T: k-step kk is 32 bytes into column block kk / 4
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(q_u + off, 16, 1024),
                   sw128_desc(k_u + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // An edge tile needs the bias, the ragged end or a mask: a tile that
    // every row of the q tile sees whole takes the plain scaled scores.
    const bool edge =
        bias_row != nullptr || k0 + TK > dm.skv ||
        (dm.causal &&
         (dm.kv_offset + k0 + TK - 1 > dm.q_offset + q0 ||
          (dm.window > 0 &&
           dm.kv_offset + k0 <= dm.q_offset + q0 + TQ - 1 - dm.window)));
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + j * 8 + 2 * t + e;
          s[j][e] = log2_score(
              masked_score(s[j][e] * scale, dm, bias_row, r0, kj));
          s[j][2 + e] = log2_score(
              masked_score(s[j][2 + e] * scale, dm, bias_row, r0 + 8, kj));
        }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    }

    float mx0 = kNegInf, mx8 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx8 = fmaxf(mx8, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx8 = fmaxf(mx8, __shfl_xor_sync(0xffffffffu, mx8, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn8 = fmaxf(m8, mx8);
    const float c0 = ex2(m0 - mn0), c8 = ex2(m8 - mn8);
    float sum0 = 0.f, sum8 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = ex2(s[j][0] - mn0);
      s[j][1] = ex2(s[j][1] - mn0);
      s[j][2] = ex2(s[j][2] - mn8);
      s[j][3] = ex2(s[j][3] - mn8);
      sum0 += s[j][0] + s[j][1];
      sum8 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum8 += __shfl_xor_sync(0xffffffffu, sum8, off);
    }
    l0 = c0 * l0 + sum0;
    l8 = c8 * l8 + sum8;
    m0 = mn0;
    m8 = mn8;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c8;
      o[n][3] *= c8;
    }

    // O += P V: k-steps of 16 positions (two 8-row swizzle groups of V),
    // P's accumulator fragments reused as the A operand
    uint32_t pa[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_pv<kD>(o, pa[kk], sw128_desc(v_u + kk * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }
  cp_async_wait_all();  // the Q copies of a block that saw no KV tile

  // out = O / l (0 where no key is visible), lse = m + log l (natural)
  const float sl0 = l0 > 0.f ? l0 : 1.f, sl8 = l8 > 0.f ? l8 : 1.f;
  __nv_bfloat16* ob = out + bb * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < dm.sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(r0) * os.s +
                                   c) = pack_f2(o[n][0] / sl0, o[n][1] / sl0);
    if (r0 + 8 < dm.sq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(r0 + 8) *
                                            os.s + c) =
          pack_f2(o[n][2] / sl8, o[n][3] / sl8);
  }
  if (t == 0) {
    float* lrow = lse + (static_cast<long long>(bb) * dm.hq + h) * dm.sq;
    if (r0 < dm.sq) lrow[r0] = l0 > 0.f ? m0 * kLn2 + logf(sl0) : kNegInf;
    if (r0 + 8 < dm.sq)
      lrow[r0 + 8] = l8 > 0.f ? m8 * kLn2 + logf(sl8) : kNegInf;
  }
}

// dQ on Hopper's warpgroup tensor cores: the forward's design. One block,
// one warpgroup (4 warps), per (64-row q tile, q head, batch), warp w owning
// q rows 16w..16w+15 of every product's accumulator. The Q and dO tiles are
// copied once by cp.async into 128-byte-swizzled shared memory; K/V tiles
// of 64 positions stream past them through a two-stage cp.async ring, tile
// j+1 in flight while tile j is multiplied, one barrier a tile. Per tile:
// S = Q K^T and dP = dO V^T as wgmma m64n64k16 (all four operands by
// K-major descriptor); p = exp2(s log2(e)/sqrt(D) - lse log2(e)) with the
// bias and the masks on an edge tile only; dS = p (dP - delta), rounded to
// bf16 and kept in registers as the A operand; dQ += dS K as wgmma
// m64n(kD)k16 with K read by the transposed (MN-major) descriptor, as the
// forward reads V. The block owns its dQ rows and writes them once: no
// atomics, no partials. At D=128 a thread holds S, dP and dQ (32 + 32 + 64
// fp32), so one warpgroup a block and two blocks an SM leave it 255
// registers.
//
// The grid is 1-D with the q tile slowest and reversed: the causal rows
// that see the most KV tiles start first and the light ones fill the tail.
//
// Shared memory (dynamic, aligned up to 1024 bytes): Q, dO, then two stages
// of [K tile][V tile], each 64 x kD bf16 in the swizzled layout.
template <int kD>
__global__ void __launch_bounds__(128, 2)
fa_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, Dims dm, Strides qs,
                     Strides ks, Strides vs, Strides dos, Strides dqs,
                     float scale) {
  constexpr int TQ = 64, TK = 64, kTileB = 64 * kD * 2;  // bytes a tile
  constexpr int KK = kD / 16, ND = kD / 8, NS = TK / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (dm.sq + TQ - 1) / TQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / (dm.hq * dm.b);
  const int h = blockIdx.x % dm.hq, bb = (blockIdx.x / dm.hq) % dm.b;
  const int hk = h / (dm.hq / dm.hkv);

  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t base = (raw + 1023u) & ~1023u;  // tile i at base + i*kTileB
  char* sm = reinterpret_cast<char*>(smem4) + (base - raw);
  auto tile = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(sm + i * kTileB);
  };

  const int q0 = qt * TQ;
  const int nq = min(TQ, dm.sq - q0);
  const int r0 = q0 + warp * 16 + g;  // this lane's rows r0 and r0 + 8
  const __nv_bfloat16* kb = k + bb * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + bb * vs.b + hk * vs.h;
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;
  const float sl2 = scale * kLog2e;

  int kt_lo, kt_hi;
  live_kv_tiles(dm, q0, nq, TK, &kt_lo, &kt_hi);
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * TK, nk = min(TK, dm.skv - k0);
    load_rows_sw128<kD, 128>(tile(2 + 2 * stage), kb, ks.s, k0, nk);
    load_rows_sw128<kD, 128>(tile(3 + 2 * stage), vb, vs.s, k0, nk);
  };
  load_rows_sw128<kD, 128>(tile(0), q + bb * qs.b + h * qs.h, qs.s, q0, nq);
  load_rows_sw128<kD, 128>(tile(1), dout + bb * dos.b + h * dos.h, dos.s, q0,
                           nq);
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  // rows past Sq: lse = delta = 0 over zero Q and dO rows, so dS = 0
  const long long row_base = (static_cast<long long>(bb) * dm.hq + h) * dm.sq;
  const float lse0 = r0 < dm.sq ? lse[row_base + r0] * kLog2e : 0.f;
  const float lse8 = r0 + 8 < dm.sq ? lse[row_base + r0 + 8] * kLog2e : 0.f;
  const float dl0 = r0 < dm.sq ? delta[row_base + r0] : 0.f;
  const float dl8 = r0 + 8 < dm.sq ? delta[row_base + r0 + 8] : 0.f;

  float acc[ND][4], s[NS][4], dp[NS][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();  // tile kt has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();      // ... everyone's; and tile kt-1 is done with
    if (kt + 1 < kt_hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    const uint32_t k_u = base + (2 + 2 * stage) * kTileB;
    const uint32_t v_u = k_u + kTileB;
    const int k0 = kt * TK;

    // S = Q K^T, dP = dO V^T: k-step kk is 32 bytes into column block kk / 4
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(base + off, 16, 1024),
                   sw128_desc(k_u + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_n64(dp, sw128_desc(base + kTileB + off, 16, 1024),
                   sw128_desc(v_u + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // An edge tile needs the bias, the ragged end or a mask: a tile that
    // every row of the q tile sees whole takes the plain scaled scores.
    const bool edge =
        bias_row != nullptr || k0 + TK > dm.skv ||
        (dm.causal &&
         (dm.kv_offset + k0 + TK - 1 > dm.q_offset + q0 ||
          (dm.window > 0 &&
           dm.kv_offset + k0 <= dm.q_offset + q0 + TQ - 1 - dm.window)));
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0, p8;
        if (edge) {
          const int kj = k0 + j * 8 + 2 * t + e;
          const float x0 = masked_score(s[j][e] * scale, dm, bias_row, r0, kj);
          const float x8 =
              masked_score(s[j][2 + e] * scale, dm, bias_row, r0 + 8, kj);
          p0 = x0 > kMasked ? ex2(x0 * kLog2e - lse0) : 0.f;
          p8 = x8 > kMasked ? ex2(x8 * kLog2e - lse8) : 0.f;
        } else {
          p0 = ex2(s[j][e] * sl2 - lse0);
          p8 = ex2(s[j][2 + e] * sl2 - lse8);
        }
        s[j][e] = p0 * (dp[j][e] - dl0);
        s[j][2 + e] = p8 * (dp[j][2 + e] - dl8);
      }

    // dQ += dS K: k-steps of 16 positions (two 8-row swizzle groups of K),
    // dS's accumulator fragments reused as the A operand
    uint32_t da[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      c_to_a(da[kk], s[2 * kk], s[2 * kk + 1]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_pv<kD>(acc, da[kk], sw128_desc(k_u + kk * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait_all();  // the Q / dO copies of a block that saw no KV tile

  __nv_bfloat16* qrow = dq + bb * dqs.b + h * dqs.h;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < dm.sq)
      *reinterpret_cast<uint32_t*>(qrow + static_cast<long long>(r0) * dqs.s +
                                   c) =
          pack_f2(acc[n][0] * scale, acc[n][1] * scale);
    if (r0 + 8 < dm.sq)
      *reinterpret_cast<uint32_t*>(
          qrow + static_cast<long long>(r0 + 8) * dqs.s + c) =
          pack_f2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// dK and dV on Hopper's warpgroup tensor cores, in two passes.
//
// Pass 1: one block, one warpgroup (4 warps), per (64-position KV tile, q
// head, batch), warp w owning KV positions 16w..16w+15 of every product's
// accumulator; the block walks only the 64-row q tiles of ITS head that
// can see the tile (at most S/64), so the GQA group's rep heads run in rep
// blocks side by side instead of one after the other. K and V are staged
// once; (Q, dO, lse, delta) tiles stream through a two-stage cp.async ring
// into 128-byte-swizzled shared memory, the next tile in flight while the
// current one is multiplied. Per q tile, four wgmma products: S^T = K Q^T
// and dP^T = V dO^T (m64n64k16, both operands by K-major descriptor), so
// that P^T and dS^T come out in registers with KV rows; p = exp2(s - lse)
// (masks only on an edge tile), dS = p (dP - delta); then dV += P^T dO and
// dK += dS^T Q (m64n(kD)k16, P^T and dS^T rounded to bf16 as A operands
// from registers, dO and Q by transposed MN-major descriptors). The block
// writes its head's fp32 partial dK (scaled) and dV into a scratch (B,
// Skv, Hq, D). KV tile 0 (under causality the longest walk) is launched
// first.
//
// Pass 2 (fa_bwd_dkdv_fold_kernel) sums the rep partials of each KV head
// in a fixed order and writes bf16 dK and dV at Hkv heads: deterministic,
// no atomics.
//
// Shared memory (dynamic, aligned up to 1024 bytes): K and V tiles, then
// two stages of [Q tile][dO tile] (64 x kD bf16, swizzled), then two
// stages of [lse][delta] (fp32).
template <int kD>
__global__ void __launch_bounds__(128, 2)
fa_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk_part,
                       float* __restrict__ dv_part, Dims dm, Strides qs,
                       Strides ks, Strides vs, Strides dos, float scale) {
  constexpr int TK = 64, TQ = 64, kTileB = 64 * kD * 2;  // bytes a tile
  constexpr int KK = kD / 16, ND = kD / 8, NQ = TQ / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kt = static_cast<int>(blockIdx.x) / (dm.hq * dm.b);
  const int h = blockIdx.x % dm.hq, bb = (blockIdx.x / dm.hq) % dm.b;
  const int hk = h / (dm.hq / dm.hkv);

  extern __shared__ float4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t base = (raw + 1023u) & ~1023u;  // tile i at base + i*kTileB
  char* sm = reinterpret_cast<char*>(smem4) + (base - raw);
  auto tile = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(sm + i * kTileB);
  };
  // tiles: 0 K, 1 V, 2 + 2s Q and 3 + 2s dO of stage s; then lse, delta
  float* row_s = reinterpret_cast<float*>(sm + 6 * kTileB);

  const int k0 = kt * TK;
  const int nk = min(TK, dm.skv - k0);
  const int kr0 = k0 + warp * 16 + g;  // this lane's KV rows kr0, kr0 + 8
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;
  const float sl2 = scale * kLog2e;

  // q tiles [qt_lo, qt_hi) that can see this KV tile
  const int n_qt = (dm.sq + TQ - 1) / TQ;
  int qt_lo = 0, qt_hi = n_qt;
  if (dm.causal) {
    const int k_first = dm.kv_offset + k0;
    const int k_last = k_first + nk - 1;
    qt_lo = max(0, floordiv(k_first - dm.q_offset, TQ));
    if (dm.window > 0)
      qt_hi = min(n_qt,
                  max(0, floordiv(k_last + dm.window - 1 - dm.q_offset, TQ) +
                             1));
  }

  const __nv_bfloat16* qb = q + bb * qs.b + h * qs.h;
  const __nv_bfloat16* ob = dout + bb * dos.b + h * dos.h;
  const long long row_base = (static_cast<long long>(bb) * dm.hq + h) *
                             dm.sq;
  auto load_q = [&](int qt, int stage) {
    const int q0 = qt * TQ, nq = min(TQ, dm.sq - q0);
    load_rows_sw128<kD, 128>(tile(2 + 2 * stage), qb, qs.s, q0, nq);
    load_rows_sw128<kD, 128>(tile(3 + 2 * stage), ob, dos.s, q0, nq);
    const int i = threadIdx.x;  // 128 threads: lse rows 0-63, delta 64-127
    const int r = i & (TQ - 1);
    const bool ok = r < nq;
    const float* src = (i < TQ ? lse : delta) + row_base + q0 + (ok ? r : 0);
    cp_async4(row_s + stage * 2 * TQ + i, src, ok);
  };
  load_rows_sw128<kD, 128>(tile(0), k + bb * ks.b + hk * ks.h, ks.s, k0, nk);
  load_rows_sw128<kD, 128>(tile(1), v + bb * vs.b + hk * vs.h, vs.s, k0, nk);
  if (qt_lo < qt_hi) load_q(qt_lo, 0);
  cp_async_commit();

  float adk[ND][4], adv[ND][4], st[NQ][4], dpt[NQ][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int stage = (qt - qt_lo) & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile qt visible to all; tile qt-1 done with
    if (qt + 1 < qt_hi) load_q(qt + 1, stage ^ 1);
    cp_async_commit();
    const uint32_t q_u = base + (2 + 2 * stage) * kTileB;
    const uint32_t do_u = q_u + kTileB;
    const float* lse_s = row_s + stage * 2 * TQ;
    const float* dl_s = lse_s + TQ;
    const int q0 = qt * TQ;

    // S^T = K Q^T and dP^T = V dO^T: k-step kk is 32 bytes into column
    // block kk / 4 of each operand
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_n64(st, sw128_desc(base + off, 16, 1024),
                   sw128_desc(q_u + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_n64(dpt, sw128_desc(base + kTileB + off, 16, 1024),
                   sw128_desc(do_u + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // element (KV row kr0 or kr0 + 8, q row j*8 + 2t + e of the tile)
    const bool edge =
        bias_row != nullptr || k0 + TK > dm.skv || q0 + TQ > dm.sq ||
        (dm.causal &&
         (dm.kv_offset + k0 + TK - 1 > dm.q_offset + q0 ||
          (dm.window > 0 &&
           dm.kv_offset + k0 <= dm.q_offset + q0 + TQ - 1 - dm.window)));
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e;
        const float lse2 = lse_s[qc] * kLog2e, dl = dl_s[qc];
        float p0, p8;
        if (edge) {
          const float x0 =
              masked_score(st[j][e] * scale, dm, bias_row, q0 + qc, kr0);
          const float x8 = masked_score(st[j][2 + e] * scale, dm, bias_row,
                                        q0 + qc, kr0 + 8);
          p0 = x0 > kMasked ? ex2(x0 * kLog2e - lse2) : 0.f;
          p8 = x8 > kMasked ? ex2(x8 * kLog2e - lse2) : 0.f;
        } else {
          p0 = ex2(st[j][e] * sl2 - lse2);
          p8 = ex2(st[j][2 + e] * sl2 - lse2);
        }
        dpt[j][e] = p0 * (dpt[j][e] - dl);
        dpt[j][2 + e] = p8 * (dpt[j][2 + e] - dl);
        st[j][e] = p0;
        st[j][2 + e] = p8;
      }

    // dV += P^T dO, dK += dS^T Q: k-steps of 16 q rows (two 8-row swizzle
    // groups of dO and Q)
    uint32_t pa[TQ / 16][4], da[TQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      c_to_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
      c_to_a(da[kk], dpt[2 * kk], dpt[2 * kk + 1]);
    }
    fence_regs(adv);
    fence_regs(adk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk)
      wgmma_pv<kD>(adv, pa[kk], sw128_desc(do_u + kk * 2048, 8192, 1024));
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk)
      wgmma_pv<kD>(adk, da[kk], sw128_desc(q_u + kk * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(adv);
    fence_regs(adk);
  }
  cp_async_wait_all();  // K/V copies of a block that walked no q tile

  // this head's partials, fp32 (B, Skv, Hq, D)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = kr0 + 8 * i;
    if (kr >= dm.skv) continue;
    const long long base_o =
        ((static_cast<long long>(bb) * dm.skv + kr) * dm.hq + h) * kD;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk_part + base_o + c) =
          make_float2(adk[n][2 * i] * scale, adk[n][2 * i + 1] * scale);
      *reinterpret_cast<float2*>(dv_part + base_o + c) =
          make_float2(adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

// dK, dV (bf16, Hkv heads) = the sum over each GQA group's rep heads of
// the fp32 partials, in head order; one thread per 4 columns of a (batch,
// position, KV head) row.
template <int kD>
__global__ void __launch_bounds__(256)
fa_bwd_dkdv_fold_kernel(const float* __restrict__ dk_part,
                        const float* __restrict__ dv_part,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, Dims dm, Strides dks,
                        Strides dvs) {
  constexpr int kC4 = kD / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(dm.b) * dm.skv * dm.hkv * kC4) return;
  const int c = static_cast<int>(i % kC4) * 4;
  const long long row = i / kC4;  // (bb * skv + s) * hkv + hk
  const int hk = static_cast<int>(row % dm.hkv);
  const long long bs = row / dm.hkv;
  const int s = static_cast<int>(bs % dm.skv);
  const int bb = static_cast<int>(bs / dm.skv);
  const int rep = dm.hq / dm.hkv;
  const long long base = (bs * dm.hq + static_cast<long long>(hk) * rep) *
                             kD + c;
  float4 ak = make_float4(0.f, 0.f, 0.f, 0.f), av = ak;
  for (int r = 0; r < rep; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(dk_part + base + r * kD);
    const float4 y = *reinterpret_cast<const float4*>(dv_part + base + r * kD);
    ak.x += x.x; ak.y += x.y; ak.z += x.z; ak.w += x.w;
    av.x += y.x; av.y += y.y; av.z += y.z; av.w += y.w;
  }
  uint2 pk, pv;
  pk.x = pack_f2(ak.x, ak.y);
  pk.y = pack_f2(ak.z, ak.w);
  pv.x = pack_f2(av.x, av.y);
  pv.y = pack_f2(av.z, av.w);
  *reinterpret_cast<uint2*>(dk + bb * dks.b + s * dks.s + hk * dks.h + c) =
      pk;
  *reinterpret_cast<uint2*>(dv + bb * dvs.b + s * dvs.s + hk * dvs.h + c) =
      pv;
}

// f32 tile shapes: forward 64 q rows x 64 positions (K and V share one
// buffer, 86 KB at D=128, two blocks per SM); dK/dV 32 positions x 32 q rows
// (two blocks per SM, and twice the blocks of a 64-position tile: only B x
// Hkv x S/32 blocks exist); dQ 32 q rows x 64 positions (109 KB, two per SM).
constexpr int kFwdNQ = 4, kFwdNK = 4;
constexpr int kDkdvNQ = 2, kDkdvNK = 2;
constexpr int kDqNQ = 2, kDqNK = 4;

template <int kD>
constexpr size_t fwd_smem(int nq, int nk) {
  return sizeof(float) * (static_cast<size_t>(16 * nq) * (kD + 4) +
                          static_cast<size_t>(16 * nk) * (kD + 4) +
                          static_cast<size_t>(16 * nq) * (16 * nk + 16));
}
template <int kD>
constexpr size_t bwd_smem(int nq, int nk, int n_score_tiles) {
  return sizeof(float) * (2 * static_cast<size_t>(16 * nq) * (kD + 4) +
                          2 * static_cast<size_t>(16 * nk) * (kD + 4) +
                          n_score_tiles * static_cast<size_t>(16 * nq) *
                              (16 * nk + 16) +
                          2 * static_cast<size_t>(16 * nq));
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

Dims dims_of(const long long* a) {
  Dims d;
  d.b = static_cast<int>(a[0]);
  d.sq = static_cast<int>(a[1]);
  d.skv = static_cast<int>(a[2]);
  d.hq = static_cast<int>(a[3]);
  d.hkv = static_cast<int>(a[4]);
  d.d = static_cast<int>(a[5]);
  d.q_offset = static_cast<int>(a[6]);
  d.kv_offset = static_cast<int>(a[7]);
  d.causal = static_cast<int>(a[8]);
  d.window = static_cast<int>(a[9]);
  return d;
}

Strides strides_of(const long long* a, int i) {
  return Strides{a[3 * i], a[3 * i + 1], a[3 * i + 2]};
}

bool dims_ok(const Dims& d) {
  return d.b > 0 && d.sq > 0 && d.skv > 0 && d.hkv > 0 && d.hq % d.hkv == 0 &&
         (d.d == 64 || d.d == 128);
}

template <int kD>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* bias,
                void* out, void* lse, const Dims& dm, const long long* st,
                cudaStream_t stream) {
  auto kern = fa_fwd_kernel<kD, kFwdNQ, kFwdNK>;
  const size_t smem = fwd_smem<kD>(kFwdNQ, kFwdNK);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dm.sq + 16 * kFwdNQ - 1) / (16 * kFwdNQ), dm.hq, dm.b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<float*>(lse), dm, strides_of(st, 0),
      strides_of(st, 1), strides_of(st, 2), strides_of(st, 3),
      1.0f / sqrtf(static_cast<float>(kD)));
  return cudaGetLastError();
}

// bf16 tensor-core kernels: the dynamic shared memory of one block.
template <int kD>
constexpr size_t fwd_mma_smem() {  // 2 Q, two stages of K and V, alignment
  return 6 * sizeof(__nv_bfloat16) * 64 * kD + 1024;
}
template <int kD>
constexpr size_t dq_mma_smem() {  // Q, dO; two stages of K and V: the same
  return fwd_mma_smem<kD>();      // six tiles as the forward's
}
template <int kD>
constexpr size_t dkdv_mma_smem() {  // K, V; two stages of Q, dO, lse, delta
  return 6 * sizeof(__nv_bfloat16) * 64 * kD + 4 * 64 * sizeof(float) + 1024;
}

// Grid sizes: 1-D, the tile index slowest (see the kernels).
inline unsigned fwd_mma_blocks(const Dims& dm) {
  return static_cast<unsigned>((dm.sq + 127) / 128) * dm.hq * dm.b;
}
inline unsigned dkdv_mma_blocks(const Dims& dm) {
  return static_cast<unsigned>((dm.skv + 63) / 64) * dm.hq * dm.b;
}
inline unsigned dq_mma_blocks(const Dims& dm) {
  return static_cast<unsigned>((dm.sq + 63) / 64) * dm.hq * dm.b;
}

template <int kD>
cudaError_t fwd_mma(const void* q, const void* k, const void* v,
                    const void* bias, void* out, void* lse, const Dims& dm,
                    const long long* st, cudaStream_t stream) {
  auto kern = fa_fwd_mma_kernel<kD>;
  const size_t smem = fwd_mma_smem<kD>();
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<fwd_mma_blocks(dm), 256, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), dm,
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 3), 1.0f / sqrtf(static_cast<float>(kD)));
  return cudaGetLastError();
}

// scratch: fp32 dK partials then dV partials, each (B, Skv, Hq, D)
template <int kD>
cudaError_t bwd_dkdv_mma(const void* q, const void* k, const void* v,
                         const void* bias, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, void* scratch,
                         const Dims& dm, const long long* st,
                         cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  auto kern = fa_bwd_dkdv_mma_kernel<kD>;
  const size_t smem = dkdv_mma_smem<kD>();
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  float* dk_part = static_cast<float*>(scratch);
  float* dv_part = dk_part + static_cast<long long>(dm.b) * dm.skv * dm.hq *
                                 kD;
  kern<<<dkdv_mma_blocks(dm), 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      dk_part, dv_part, dm, strides_of(st, 0), strides_of(st, 1),
      strides_of(st, 2), strides_of(st, 3),
      1.0f / sqrtf(static_cast<float>(kD)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(dm.b) * dm.skv * dm.hkv *
                      (kD / 4);
  fa_bwd_dkdv_fold_kernel<kD><<<static_cast<unsigned>((n + 255) / 256), 256,
                                0, stream>>>(
      dk_part, dv_part, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), dm, strides_of(st, 4),
      strides_of(st, 5));
  return cudaGetLastError();
}

template <int kD>
cudaError_t bwd_dq_mma(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const void* lse,
                       const void* delta, void* dq, const Dims& dm,
                       const long long* st, cudaStream_t stream) {
  auto kern = fa_bwd_dq_mma_kernel<kD>;
  const size_t smem = dq_mma_smem<kD>();
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dq_mma_blocks(dm), 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), dm, strides_of(st, 0),
      strides_of(st, 1), strides_of(st, 2), strides_of(st, 3),
      strides_of(st, 4), 1.0f / sqrtf(static_cast<float>(kD)));
  return cudaGetLastError();
}

template <int kD>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, const Dims& dm,
                     const long long* st, cudaStream_t stream) {
  auto kern = fa_bwd_dkdv_kernel<kD, kDkdvNQ, kDkdvNK>;
  const size_t smem = bwd_smem<kD>(kDkdvNQ, kDkdvNK, 2);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dm.skv + 16 * kDkdvNK - 1) / (16 * kDkdvNK), dm.hkv, dm.b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), dm, strides_of(st, 0), strides_of(st, 1),
      strides_of(st, 2), strides_of(st, 3), strides_of(st, 4),
      strides_of(st, 5), 1.0f / sqrtf(static_cast<float>(kD)));
  return cudaGetLastError();
}

template <int kD>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, void* dq, const Dims& dm,
                   const long long* st, cudaStream_t stream) {
  auto kern = fa_bwd_dq_kernel<kD, kDqNQ, kDqNK>;
  const size_t smem = bwd_smem<kD>(kDqNQ, kDqNK, 1);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dm.sq + 16 * kDqNQ - 1) / (16 * kDqNQ), dm.hq, dm.b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), dm,
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 3), strides_of(st, 4),
      1.0f / sqrtf(static_cast<float>(kD)));
  return cudaGetLastError();
}

}  // namespace

// dims: b, sq, skv, hq, hkv, d, q_offset, kv_offset, causal, window (0 =
// none). strides: (batch, seq, head) element strides of each tensor in
// argument order. dtype: 0 = f32, 1 = bf16, for every q/k/v/dO/output
// operand; bias (B, Skv), lse and delta (B, Hq, Sq) are contiguous f32.
// Each returns the cudaError_t of its launch (0 on success), launches on
// `stream` and does not synchronise.

extern "C" int swi_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       void* out, void* lse,
                                       const long long* dims,
                                       const long long* strides, int dtype,
                                       void* stream) {
  const Dims dm = dims_of(dims);
  if (!dims_ok(dm)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && dm.d == 64)
    err = fwd<64>(q, k, v, bias, out, lse, dm, strides, s);
  else if (dtype == 0 && dm.d == 128)
    err = fwd<128>(q, k, v, bias, out, lse, dm, strides, s);
  else if (dtype == 1 && dm.d == 64)
    err = fwd_mma<64>(q, k, v, bias, out, lse, dm, strides, s);
  else if (dtype == 1 && dm.d == 128)
    err = fwd_mma<128>(q, k, v, bias, out, lse, dm, strides, s);
  return static_cast<int>(err);
}

extern "C" int swi_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    void* scratch, const long long* dims, const long long* strides,
    int dtype, void* stream) {
  const Dims dm = dims_of(dims);
  if (!dims_ok(dm)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && dm.d == 64)
    err = bwd_dkdv<64>(q, k, v, bias, dout, lse, delta, dk, dv, dm,
                              strides, s);
  else if (dtype == 0 && dm.d == 128)
    err = bwd_dkdv<128>(q, k, v, bias, dout, lse, delta, dk, dv, dm,
                               strides, s);
  else if (dtype == 1 && dm.d == 64)
    err = bwd_dkdv_mma<64>(q, k, v, bias, dout, lse, delta, dk, dv, scratch,
                           dm, strides, s);
  else if (dtype == 1 && dm.d == 128)
    err = bwd_dkdv_mma<128>(q, k, v, bias, dout, lse, delta, dk, dv,
                            scratch, dm, strides, s);
  return static_cast<int>(err);
}

extern "C" int swi_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq,
    const long long* dims, const long long* strides, int dtype,
    void* stream) {
  const Dims dm = dims_of(dims);
  if (!dims_ok(dm)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && dm.d == 64)
    err = bwd_dq<64>(q, k, v, bias, dout, lse, delta, dq, dm, strides,
                            s);
  else if (dtype == 0 && dm.d == 128)
    err = bwd_dq<128>(q, k, v, bias, dout, lse, delta, dq, dm, strides,
                             s);
  else if (dtype == 1 && dm.d == 64)
    err = bwd_dq_mma<64>(q, k, v, bias, dout, lse, delta, dq, dm, strides, s);
  else if (dtype == 1 && dm.d == 128)
    err = bwd_dq_mma<128>(q, k, v, bias, dout, lse, delta, dq, dm, strides,
                          s);
  return static_cast<int>(err);
}

namespace {

template <typename K>
cudaError_t occupancy_of(K kern, size_t smem, int threads, int* out) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem);
  out[2] = threads;
  out[3] = blocks;
  return err;
}

template <int kD>
cudaError_t occupancy(int which, int* out) {
  if (which == 0)
    return occupancy_of(fa_fwd_mma_kernel<kD>, fwd_mma_smem<kD>(), 256, out);
  if (which == 1)
    return occupancy_of(fa_bwd_dkdv_mma_kernel<kD>, dkdv_mma_smem<kD>(), 128,
                        out);
  if (which == 2)
    return occupancy_of(fa_bwd_dq_mma_kernel<kD>, dq_mma_smem<kD>(), 128,
                        out);
  return cudaErrorInvalidValue;
}

}  // namespace

// The bf16 kernels' resources as the card reports them: which 0 = forward,
// 1 = dK/dV (its first pass), 2 = dQ; out[4] = registers per thread,
// dynamic shared bytes per block, threads per block, resident blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int swi_flash_attention_occupancy(int which, int d, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64)
    err = occupancy<64>(which, out);
  else if (d == 128)
    err = occupancy<128>(which, out);
  return static_cast<int>(err);
}
