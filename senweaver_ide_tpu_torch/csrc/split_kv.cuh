// Shared pieces of the two split-KV decode kernels for NVIDIA Hopper
// (sm_90a): flash_decode.cu (K3, a contiguous cache) and paged_attention.cu
// (K1, a block-table pool). Both run pass 1 as one block of four warps per
// (split, KV head, slot or query tile) over 64-position K/V tiles in a
// cp.async ring, with the products on mma.sync m16n8k16 (bf16 in, fp32
// out) and up to 16 query rows padded to one m16 A operand; pass 2 merges
// each output row's splits. What differs is how a block finds and masks its
// positions, which stays in each source.
//
// Here: the PTX wrappers, one 16-position step of a warp (scores, then the
// online softmax and P.V), the end-of-block merge of the four warps, and
// pass 2's merge of one output row. No kernel entry lives here, so each
// source keeps its own kernels' names.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kSplitTile = 64;      // positions a K/V tile holds
constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kStages = 2;          // the cp.async ring
constexpr int kMaxRep = 16;         // query rows of one mma A operand
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;   // finite, as in the reference kernels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that does not pass through registers;
// `valid` false writes 16 zero bytes and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l names row l % 8 of
// matrix l / 8. Plain: lane T gets M[T/4][2(T%4)..+1] of each; trans: lane
// T gets M[2(T%4)..+1][T/4].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// mma.sync m16n8k16, bf16 in, fp32 accumulate. With g = lane / 4 and t =
// lane % 4: A regs hold A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]; B regs B[2t..2t+1][g], B[2t+8..2t+9][g]; C holds
// C[g][2t..2t+1] then C[g+8][2t..2t+1]. The lower index sits in the lower
// 16 bits.
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

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Scores of one warp's 16 positions: sc = Q K^T over kD/16 k-steps, as the
// C fragments of two 8-position n-tiles. `k_lane` is this lane's ldmatrix
// row of the step's K rows (plain), at column 8 * ((lane / 8) % 2).
template <int kD>
__device__ __forceinline__ void score_step(float (&sc)[2][4],
                                           const uint32_t (&qa)[kD / 16][4],
                                           const __nv_bfloat16* k_lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t kf[4];
    ldsm_x4(kf, k_lane + kk * 16);
    mma_bf16(sc[0], qa[kk], kf[0], kf[1]);
    mma_bf16(sc[1], qa[kk], kf[2], kf[3]);
  }
}

// The online softmax and P.V of one warp's 16-position step for its rows g
// (m0, l0) and g + 8 (m8, l8). `sc` holds the scores in the log2 domain,
// -inf where a position is masked. m starts at the finite kNegInf, so a
// step whose scores are all -inf for a row (every position past its
// length, as a query tile's shorter rows meet) gives that row a correction
// ex2(m - m) = 1 and P = ex2(-inf) = 0: (m, l, o) stay as they were, and a
// warp that saw no live position ends with l = 0, which the merges skip.
// `v_lane` is this lane's ldmatrix.trans row of the step's V rows, at
// column 8 * (lane / 16). With kVScale, `vs_lane` (the step's V scales
// from position 2 * (lane % 4)) multiply P's columns after l is summed:
// V's dequant scale folded into P.
template <int kD, bool kVScale>
__device__ __forceinline__ void softmax_pv_step(
    float (&sc)[2][4], float& m0, float& m8, float& l0, float& l8,
    float (&o)[kD / 8][4], const __nv_bfloat16* v_lane,
    const float* vs_lane) {
  float mx0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
  float mx8 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx8 = fmaxf(mx8, __shfl_xor_sync(0xffffffffu, mx8, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn8 = fmaxf(m8, mx8);
  const float cr0 = ex2(m0 - mn0), cr8 = ex2(m8 - mn8);
  float sum0 = 0.f, sum8 = 0.f;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    sc[n][0] = ex2(sc[n][0] - mn0);
    sc[n][1] = ex2(sc[n][1] - mn0);
    sc[n][2] = ex2(sc[n][2] - mn8);
    sc[n][3] = ex2(sc[n][3] - mn8);
    sum0 += sc[n][0] + sc[n][1];
    sum8 += sc[n][2] + sc[n][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum8 += __shfl_xor_sync(0xffffffffu, sum8, off);
  }
  l0 = cr0 * l0 + sum0;
  l8 = cr8 * l8 + sum8;
  m0 = mn0;
  m8 = mn8;
  if constexpr (kVScale) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= vs_lane[8 * n + (e & 1)];
  }
  // P (C fragments of the two n-tiles) as the A operand of one k-step
  uint32_t pa[4];
  pa[0] = pack_f2(sc[0][0], sc[0][1]);
  pa[1] = pack_f2(sc[0][2], sc[0][3]);
  pa[2] = pack_f2(sc[1][0], sc[1][1]);
  pa[3] = pack_f2(sc[1][2], sc[1][3]);
#pragma unroll
  for (int dd = 0; dd < kD / 16; ++dd) {
    uint32_t vf[4];
    ldsm_x4_t(vf, v_lane + dd * 16);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * dd][e] *= e < 2 ? cr0 : cr8;
      o[2 * dd + 1][e] *= e < 2 ? cr0 : cr8;
    }
    mma_bf16(o[2 * dd], pa, vf[0], vf[1]);
    mma_bf16(o[2 * dd + 1], pa, vf[2], vf[3]);
  }
}

// End of pass 1: each warp stores its (m, l) and the first `rows` rows of
// its accumulator, ml_s [4 warps][16][2] and acc_s [4 warps][rows][kD], in
// shared memory the ring no longer needs; after a barrier, merge_warps
// gives row r's merged (m, l) and column c of its accumulator.
template <int kD>
__device__ __forceinline__ void stash_warp(float* ml_s, float* acc_s,
                                           int rows, float m0, float l0,
                                           float m8, float l8,
                                           const float (&o)[kD / 8][4]) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4,
            t = threadIdx.x % 4;
  if (t == 0) {
    ml_s[(warp * kMaxRep + g) * 2] = m0;
    ml_s[(warp * kMaxRep + g) * 2 + 1] = l0;
    ml_s[(warp * kMaxRep + g + 8) * 2] = m8;
    ml_s[(warp * kMaxRep + g + 8) * 2 + 1] = l8;
  }
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (g < rows)
      *reinterpret_cast<float2*>(acc_s + (warp * rows + g) * kD + c) =
          make_float2(o[n][0], o[n][1]);
    if (g + 8 < rows)
      *reinterpret_cast<float2*>(acc_s + (warp * rows + g + 8) * kD + c) =
          make_float2(o[n][2], o[n][3]);
  }
}

// The four warps' partials of row r merged in warp order (warps with l = 0
// skipped): returns column c of the sum, with the merged m in `big` and l
// in `sl`.
template <int kD>
__device__ __forceinline__ float merge_warps(const float* ml_s,
                                             const float* acc_s, int rows,
                                             int r, int c, float& big,
                                             float& sl) {
  float mw[4], lw[4];
  big = kNegInf;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    mw[w] = ml_s[(w * kMaxRep + r) * 2];
    lw[w] = ml_s[(w * kMaxRep + r) * 2 + 1];
    if (lw[w] > 0.f) big = fmaxf(big, mw[w]);
  }
  float acc = 0.f;
  sl = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if (lw[w] > 0.f) {
      const float f = ex2(mw[w] - big);
      sl += lw[w] * f;
      acc += acc_s[(w * rows + r) * kD + c] * f;
    }
  }
  return acc;
}

// Pass 2 for four output columns [c, c + 4) of one row: its first `n_live`
// splits' fp32 partials, split s at row pr0 + s * stride of part_acc
// [..][kD] (the un-normalised sum) and part_ml [..][2] (m in the log2
// domain, l), merged in split order in one pass (a running max, the sum
// rescaled as it grows), normalised and written to `out` as bf16. Splits
// with l = 0 weigh nothing; no live split gives exactly 0.
template <int kD>
__device__ __forceinline__ void merge_splits(const float* __restrict__ part_acc,
                                             const float* __restrict__ part_ml,
                                             long long pr0, int stride,
                                             int n_live, int c,
                                             __nv_bfloat16* out) {
  float big = kNegInf, sl = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_live; ++s) {
    const long long pr = pr0 + static_cast<long long>(s) * stride;
    const float m = part_ml[pr * 2], l = part_ml[pr * 2 + 1];
    const float4 a = *reinterpret_cast<const float4*>(part_acc + pr * kD + c);
    if (l > 0.f) {
      const float nbig = fmaxf(big, m);
      const float fo = ex2(big - nbig), f = ex2(m - nbig);
      sl = sl * fo + l * f;
      acc.x = acc.x * fo + a.x * f;
      acc.y = acc.y * fo + a.y * f;
      acc.z = acc.z * fo + a.z * f;
      acc.w = acc.w * fo + a.w * f;
      big = nbig;
    }
  }
  const float inv = sl > 0.f ? 1.f / sl : 0.f;
  uint2 pk;
  pk.x = pack_f2(acc.x * inv, acc.y * inv);
  pk.y = pack_f2(acc.z * inv, acc.w * inv);
  *reinterpret_cast<uint2*>(out + c) = pk;
}

}  // namespace
