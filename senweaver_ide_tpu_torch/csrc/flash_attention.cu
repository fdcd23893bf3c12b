// Flash attention forward and backward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces, in senweaver_ide_tpu/ops/flash_attention.py, the Pallas TPU
// kernel _fa_kernel (line 48; launched by _fa_forward, line 116, for the
// public flash_attention, line 304) and the blockwise lax.scan backward
// _fa_backward_blockwise (line 177) of its custom VJP _make_flash_fn
// (line 262). Three kernels, each in two instances by operand type:
//
//   forward   one block per (q tile, q head, batch): out and the
//             logsumexp, online softmax in fp32 over the live KV tiles.
//   dK / dV   one block per (KV tile, KV head, batch): loops over the
//             rep = Hq/Hkv query heads of its GQA group and the q tiles
//             that can see the tile, recomputing p = exp(s - lse), and
//             writes dK and dV at Hkv heads (no atomics, K/V never
//             repeated), as the JAX backward folds the group.
//   dQ        one block per (q tile, q head, batch): loops over the live
//             KV tiles and accumulates dQ = scale * dS K.
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
// 4*B*Hq*Sq*Skv*D flops, about halved by causality, on ~60 MB of input: far
// above the ~295 flops per byte where the card stops being bound by its
// memory. The backward does 2.5x the forward's products (3.5x here, since
// the dK/dV and dQ kernels each recompute s and dP). So the kernels are
// bound by tensor-core throughput, and the design puts the bf16 instances,
// the training path, on the tensor cores: mma.sync m16n8k16 bf16 tiles with
// fp32 accumulators, operands in bf16 shared memory, the softmax applied to
// the accumulator fragments in registers, and P / dS reused from the
// accumulators as the next product's operand (rounded to bf16, as SDPA and
// FlashAttention-2 do). The f32 instances, which the tests use, keep exact
// fp32 products on the CUDA cores from fp32 tiles in shared memory. Neither
// uses wgmma, TMA, asynchronous copies or warp specialisation yet: loads
// and products of a tile do not overlap, which is where the remaining gap
// to the bound lies.

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
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Fragment layout, with
// g = lane / 4 and t = lane % 4: A (16 x 16, row) regs hold A[g][2t..2t+1],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; B (16 x 8, col) regs hold
// B[2t..2t+1][g], B[2t+8..2t+9][g]; C (16 x 8) holds C[g][2t..2t+1] then
// C[g+8][2t..2t+1]. The lower index sits in the lower 16 bits.

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 of one column, from rows r and r + 1 of a row-major tile.
__device__ __forceinline__ uint32_t pack_col(const __nv_bfloat16* p, int ld) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(p[0])) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(p[ld])) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy `rows` rows of kD bf16 from `src` into the shared tile `dst` (row
// stride kD + 8, so fragment loads of 8 consecutive rows hit distinct
// banks), zero past `n_valid`. kN threads.
template <int kD, int kN>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int row0,
                                           int n_valid, int rows) {
  constexpr int kVpr = kD / 8;
  for (int i = threadIdx.x; i < rows * kVpr; i += kN) {
    const int r = i / kVpr;
    const int c = (i % kVpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (kD + 8) + c) = v;
  }
}

// One block of 4 warps per (64-row q tile, q head, batch); warp w owns q
// rows 16w..16w+15 and keeps them as A fragments in registers. Per
// 64-position KV tile: S = Q K^T (8 n-tiles), scale, bias and masks, the
// online softmax on the C fragments (a row's values sit in the 4 lanes of
// one g, reduced with two shuffles), then P (rounded to bf16, as the
// fragments convert C to A in place) times V into 16 (D=128) fp32 output
// n-tiles.
template <int kD>
__global__ void __launch_bounds__(128)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  Dims dm, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale) {
  constexpr int TQ = 64, TK = 64, kLd = kD + 8;
  constexpr int KK = kD / 16;   // k-steps over the head dim
  constexpr int ND = kD / 8;    // output n-tiles
  constexpr int NS = TK / 8;    // score n-tiles
  const int qt = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hk = h / (dm.hq / dm.hkv);

  __shared__ __align__(16) __nv_bfloat16 k_s[TK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[TK * kLd];

  const int q0 = qt * TQ;
  const int nq = min(TQ, dm.sq - q0);
  const int r0 = q0 + warp * 16 + g;  // this lane's rows r0 and r0 + 8
  const __nv_bfloat16* qb = q + bb * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + bb * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + bb * vs.b + hk * vs.h;
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;

  uint32_t qa[KK][4];
  {
    const __nv_bfloat16* row0 = qb + static_cast<long long>(r0) * qs.s;
    const __nv_bfloat16* row8 = qb + static_cast<long long>(r0 + 8) * qs.s;
    const bool ok0 = r0 < dm.sq, ok8 = r0 + 8 < dm.sq;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = ok0 ? ld32(row0 + c) : 0u;
      qa[kk][1] = ok8 ? ld32(row8 + c) : 0u;
      qa[kk][2] = ok0 ? ld32(row0 + c + 8) : 0u;
      qa[kk][3] = ok8 ? ld32(row8 + c + 8) : 0u;
    }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m8 = kNegInf, l0 = 0.f, l8 = 0.f;

  int kt_lo, kt_hi;
  live_kv_tiles(dm, q0, nq, TK, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * TK;
    const int nk = min(TK, dm.skv - k0);
    __syncthreads();  // previous tile's products done with k_s and v_s
    stage_bf16<kD, 128>(k_s, kb, ks.s, k0, nk, TK);
    stage_bf16<kD, 128>(v_s, vb, vs.s, k0, nk, TK);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kr = k_s + (j * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }

    float mx0 = kNegInf, mx8 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + j * 8 + 2 * t + e;
        s[j][e] = masked_score(s[j][e] * scale, dm, bias_row, r0, kj);
        s[j][2 + e] =
            masked_score(s[j][2 + e] * scale, dm, bias_row, r0 + 8, kj);
        mx0 = fmaxf(mx0, s[j][e]);
        mx8 = fmaxf(mx8, s[j][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx8 = fmaxf(mx8, __shfl_xor_sync(0xffffffffu, mx8, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn8 = fmaxf(m8, mx8);
    const float c0 = expf(m0 - mn0), c8 = expf(m8 - mn8);
    float sum0 = 0.f, sum8 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = s[j][e] > kMasked ? expf(s[j][e] - mn0) : 0.f;
        s[j][2 + e] = s[j][2 + e] > kMasked ? expf(s[j][2 + e] - mn8) : 0.f;
        sum0 += s[j][e];
        sum8 += s[j][2 + e];
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

    // O += P V: k-steps of 16 positions, P's C fragments reused as A
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vr = v_s + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma_bf16(o[n], pa, pack_col(vr + n * 8, kLd),
                 pack_col(vr + 8 * kLd + n * 8, kLd));
    }
  }

  // out = O / l (0 where no key is visible), lse = m + log l
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
    if (r0 < dm.sq) lrow[r0] = l0 > 0.f ? m0 + logf(sl0) : kNegInf;
    if (r0 + 8 < dm.sq) lrow[r0 + 8] = l8 > 0.f ? m8 + logf(sl8) : kNegInf;
  }
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

// A fragment (16 rows from `row` on, 16 columns from `col` on) of a
// row-major bf16 shared tile with row stride ld.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int row, int col) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const __nv_bfloat16* p = tile + (row + g) * ld + col + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// dQ on the tensor cores: one block of 4 warps per (64-row q tile, q head,
// batch), warp w owning q rows 16w..16w+15 with their Q and dO rows as A
// fragments in registers. Per 64-position KV tile: S = Q K^T and dP = dO
// V^T, p = exp(s - lse), dS = p (dP - delta) (rounded to bf16 as an A
// fragment), dQ += dS K with K read down its columns.
template <int kD>
__global__ void __launch_bounds__(128)
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
  constexpr int TQ = 64, TK = 64, kLd = kD + 8;
  constexpr int KK = kD / 16, ND = kD / 8, NS = TK / 8;
  const int qt = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hk = h / (dm.hq / dm.hkv);

  __shared__ __align__(16) __nv_bfloat16 k_s[TK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[TK * kLd];

  const int q0 = qt * TQ;
  const int nq = min(TQ, dm.sq - q0);
  const int r0 = q0 + warp * 16 + g;
  const __nv_bfloat16* kb = k + bb * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + bb * vs.b + hk * vs.h;
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;

  uint32_t qa[KK][4], oa[KK][4];
  {
    const __nv_bfloat16* qb = q + bb * qs.b + h * qs.h;
    const __nv_bfloat16* ob = dout + bb * dos.b + h * dos.h;
    const bool ok0 = r0 < dm.sq, ok8 = r0 + 8 < dm.sq;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int c = kk * 16 + 2 * t;
      const long long a0 = static_cast<long long>(r0) * qs.s + c;
      const long long a8 = static_cast<long long>(r0 + 8) * qs.s + c;
      const long long d0 = static_cast<long long>(r0) * dos.s + c;
      const long long d8 = static_cast<long long>(r0 + 8) * dos.s + c;
      qa[kk][0] = ok0 ? ld32(qb + a0) : 0u;
      qa[kk][1] = ok8 ? ld32(qb + a8) : 0u;
      qa[kk][2] = ok0 ? ld32(qb + a0 + 8) : 0u;
      qa[kk][3] = ok8 ? ld32(qb + a8 + 8) : 0u;
      oa[kk][0] = ok0 ? ld32(ob + d0) : 0u;
      oa[kk][1] = ok8 ? ld32(ob + d8) : 0u;
      oa[kk][2] = ok0 ? ld32(ob + d0 + 8) : 0u;
      oa[kk][3] = ok8 ? ld32(ob + d8 + 8) : 0u;
    }
  }
  const long long row_base = (static_cast<long long>(bb) * dm.hq + h) * dm.sq;
  const float lse0 = r0 < dm.sq ? lse[row_base + r0] : 0.f;
  const float lse8 = r0 + 8 < dm.sq ? lse[row_base + r0 + 8] : 0.f;
  const float dl0 = r0 < dm.sq ? delta[row_base + r0] : 0.f;
  const float dl8 = r0 + 8 < dm.sq ? delta[row_base + r0 + 8] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int kt_lo, kt_hi;
  live_kv_tiles(dm, q0, nq, TK, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * TK;
    const int nk = min(TK, dm.skv - k0);
    __syncthreads();  // previous tile's products done with k_s and v_s
    stage_bf16<kD, 128>(k_s, kb, ks.s, k0, nk, TK);
    stage_bf16<kD, 128>(v_s, vb, vs.s, k0, nk, TK);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int off = (j * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[j], qa[kk], ld32(k_s + off), ld32(k_s + off + 8));
        mma_bf16(dp[j], oa[kk], ld32(v_s + off), ld32(v_s + off + 8));
      }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + j * 8 + 2 * t + e;
        const float x0 = masked_score(s[j][e] * scale, dm, bias_row, r0, kj);
        const float x8 =
            masked_score(s[j][2 + e] * scale, dm, bias_row, r0 + 8, kj);
        const float p0 = x0 > kMasked ? expf(x0 - lse0) : 0.f;
        const float p8 = x8 > kMasked ? expf(x8 - lse8) : 0.f;
        s[j][e] = p0 * (dp[j][e] - dl0);
        s[j][2 + e] = p8 * (dp[j][2 + e] - dl8);
      }
    // dQ += dS K over the tile's positions
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
      const __nv_bfloat16* kr = k_s + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        mma_bf16(acc[n], da, pack_col(kr + n * 8, kLd),
                 pack_col(kr + 8 * kLd + n * 8, kLd));
    }
  }

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

// dK and dV on the tensor cores: one block of 2 warps per (32-position KV
// tile, KV head, batch), warp w owning positions 16w..16w+15. It loops over
// the GQA group's rep heads and the 32-row q tiles that can see the tile,
// computing the transposed products so that P^T and dS^T come out as C
// fragments with KV rows: S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and
// dK += dS^T Q with dO and Q read down their columns. dK and dV are written
// once, at Hkv heads.
template <int kD>
__global__ void __launch_bounds__(64)
fa_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Dims dm, Strides qs,
                       Strides ks, Strides vs, Strides dos, Strides dks,
                       Strides dvs, float scale) {
  constexpr int TK = 32, TQ = 32, kLd = kD + 8;
  constexpr int KK = kD / 16, ND = kD / 8, NQ = TQ / 8;
  const int kt = blockIdx.x, hk = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rep = dm.hq / dm.hkv;

  __shared__ __align__(16) __nv_bfloat16 k_s[TK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[TK * kLd];
  __shared__ __align__(16) __nv_bfloat16 q_s[TQ * kLd];
  __shared__ __align__(16) __nv_bfloat16 do_s[TQ * kLd];
  __shared__ float lse_s[TQ], dl_s[TQ];

  const int k0 = kt * TK;
  const int nk = min(TK, dm.skv - k0);
  const int lr = warp * 16;              // this warp's first local KV row
  const int kr0 = k0 + lr + g;           // this lane's KV rows kr0, kr0 + 8
  stage_bf16<kD, 64>(k_s, k + bb * ks.b + hk * ks.h, ks.s, k0, nk, TK);
  stage_bf16<kD, 64>(v_s, v + bb * vs.b + hk * vs.h, vs.s, k0, nk, TK);
  const float* bias_row = bias ? bias + static_cast<long long>(bb) * dm.skv
                               : nullptr;

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

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const __nv_bfloat16* qb = q + bb * qs.b + h * qs.h;
    const __nv_bfloat16* ob = dout + bb * dos.b + h * dos.h;
    const long long row_base = (static_cast<long long>(bb) * dm.hq + h) *
                               dm.sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * TQ;
      const int nq = min(TQ, dm.sq - q0);
      __syncthreads();  // previous tile's products done with q_s .. dl_s
      stage_bf16<kD, 64>(q_s, qb, qs.s, q0, nq, TQ);
      stage_bf16<kD, 64>(do_s, ob, dos.s, q0, nq, TQ);
      for (int i = threadIdx.x; i < TQ; i += 64) {
        lse_s[i] = i < nq ? lse[row_base + q0 + i] : 0.f;
        dl_s[i] = i < nq ? delta[row_base + q0 + i] : 0.f;
      }
      __syncthreads();

      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t ka[4], va[4];
        a_frag(ka, k_s, kLd, lr, kk * 16);
        a_frag(va, v_s, kLd, lr, kk * 16);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int off = (j * 8 + g) * kLd + kk * 16 + 2 * t;
          mma_bf16(st[j], ka, ld32(q_s + off), ld32(q_s + off + 8));
          mma_bf16(dpt[j], va, ld32(do_s + off), ld32(do_s + off + 8));
        }
      }
      // element (KV row kr0 or kr0 + 8, q column j*8 + 2t + e)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = j * 8 + 2 * t + e;
          const float x0 =
              masked_score(st[j][e] * scale, dm, bias_row, q0 + qc, kr0);
          const float x8 = masked_score(st[j][2 + e] * scale, dm, bias_row,
                                        q0 + qc, kr0 + 8);
          const float p0 = x0 > kMasked ? expf(x0 - lse_s[qc]) : 0.f;
          const float p8 = x8 > kMasked ? expf(x8 - lse_s[qc]) : 0.f;
          dpt[j][e] = p0 * (dpt[j][e] - dl_s[qc]);
          dpt[j][2 + e] = p8 * (dpt[j][2 + e] - dl_s[qc]);
          st[j][e] = p0;
          st[j][2 + e] = p8;
        }
      // dV += P^T dO, dK += dS^T Q over the tile's q rows
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
        const int off = (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          mma_bf16(adv[n], pa, pack_col(do_s + off + n * 8, kLd),
                   pack_col(do_s + off + 8 * kLd + n * 8, kLd));
          mma_bf16(adk[n], da, pack_col(q_s + off + n * 8, kLd),
                   pack_col(q_s + off + 8 * kLd + n * 8, kLd));
        }
      }
    }
  }

  __nv_bfloat16* kout = dk + bb * dks.b + hk * dks.h;
  __nv_bfloat16* vout = dv + bb * dvs.b + hk * dvs.h;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (kr0 < dm.skv) {
      *reinterpret_cast<uint32_t*>(kout + static_cast<long long>(kr0) *
                                              dks.s + c) =
          pack_f2(adk[n][0] * scale, adk[n][1] * scale);
      *reinterpret_cast<uint32_t*>(vout + static_cast<long long>(kr0) *
                                              dvs.s + c) =
          pack_f2(adv[n][0], adv[n][1]);
    }
    if (kr0 + 8 < dm.skv) {
      *reinterpret_cast<uint32_t*>(kout + static_cast<long long>(kr0 + 8) *
                                              dks.s + c) =
          pack_f2(adk[n][2] * scale, adk[n][3] * scale);
      *reinterpret_cast<uint32_t*>(vout + static_cast<long long>(kr0 + 8) *
                                              dvs.s + c) =
          pack_f2(adv[n][2], adv[n][3]);
    }
  }
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

template <int kD>
cudaError_t fwd_mma(const void* q, const void* k, const void* v,
                    const void* bias, void* out, void* lse, const Dims& dm,
                    const long long* st, cudaStream_t stream) {
  const dim3 grid((dm.sq + 63) / 64, dm.hq, dm.b);
  fa_fwd_mma_kernel<kD><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), dm,
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 3), 1.0f / sqrtf(static_cast<float>(kD)));
  return cudaGetLastError();
}

template <int kD>
cudaError_t bwd_dkdv_mma(const void* q, const void* k, const void* v,
                         const void* bias, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, const Dims& dm,
                         const long long* st, cudaStream_t stream) {
  const dim3 grid((dm.skv + 31) / 32, dm.hkv, dm.b);
  fa_bwd_dkdv_mma_kernel<kD><<<grid, 64, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), dm,
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 3), strides_of(st, 4), strides_of(st, 5),
      1.0f / sqrtf(static_cast<float>(kD)));
  return cudaGetLastError();
}

template <int kD>
cudaError_t bwd_dq_mma(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const void* lse,
                       const void* delta, void* dq, const Dims& dm,
                       const long long* st, cudaStream_t stream) {
  const dim3 grid((dm.sq + 63) / 64, dm.hq, dm.b);
  fa_bwd_dq_mma_kernel<kD><<<grid, 128, 0, stream>>>(
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
    const long long* dims, const long long* strides, int dtype,
    void* stream) {
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
    err = bwd_dkdv_mma<64>(q, k, v, bias, dout, lse, delta, dk, dv, dm,
                           strides, s);
  else if (dtype == 1 && dm.d == 128)
    err = bwd_dkdv_mma<128>(q, k, v, bias, dout, lse, delta, dk, dv, dm,
                            strides, s);
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
