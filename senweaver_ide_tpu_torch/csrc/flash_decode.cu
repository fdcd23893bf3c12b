// Flash-decode over a contiguous KV cache for NVIDIA Hopper (sm_90a), plain
// C interface.
//
// Replaces the Pallas TPU kernel senweaver_ide_tpu/ops/flash_decode.py::
// _fd_kernel (public function flash_decode). For each slot b and each of its
// Hq query heads it computes Sq=1 attention over positions [0, lengths[b])
// of the slot's cache row, reading position p of KV head h at
//   cache + b * stride_b + p * stride_s + h * D
// (the (B, Smax, Hkv, D) layout with the (Hkv, D) tail contiguous; one layer
// of the engine's (L, B, Smax, Hkv, D) cache, or a B=1 slot view of it).
// Softmax is online, in fp32, with scale 1/sqrt(D). Positions at or past the
// length are never read, so a ragged Smax needs no padding and a slot's stale
// tail cannot leak in. A slot with lengths[b] == 0 writes zeros, as the TPU
// kernel's safe_l division does.
//
// What bounds it: at Sq=1 each KV byte read feeds two multiply-adds per query
// row of its GQA group (rep = Hq/Hkv: 4 for Mistral-7B, 6 for
// Qwen2.5-Coder-1.5B), far below the ~295 operations per byte at which the
// H100's compute becomes the limit, so the work is bound by the bytes of live
// KV it reads, once per (slot, KV head): 151 MB for 16 Mistral slots of
// 512..4096 positions, 45 us at 3.35 TB/s. Reaching that needs two things:
// enough blocks to cover the 132 SMs, whatever B * Hkv is (128 blocks for
// Mistral at 16 slots, 32 for Qwen2.5-Coder-1.5B), and tens of KB in flight
// on every SM (3.35 TB/s over 132 SMs is 25 bytes a nanosecond each, and a
// load takes about a microsecond to return).
//
// The bf16 design (D 64 and 128, rep <= 16: every model the port serves) is
// split-KV in two passes:
//
//   pass 1  fd_split_kernel: one block of 4 warps per (split, KV head, slot)
//           walks its chunk of positions (a multiple of the 64-position
//           tile; the split plan comes from shapes only, on the host, so
//           B * Hkv * splits asks for about 4 blocks an SM without the
//           lengths ever leaving the device). A block whose chunk starts
//           at or past its slot's length exits at once. K/V tiles arrive by
//           cp.async 16-byte copies, bf16 and unwidened, into a two-stage
//           ring with one barrier a tile: the next tile (32 KB at D=128)
//           is in flight while one is scored, and three blocks fit an SM,
//           so about 100 KB an SM are in flight. cp.async zero-fills
//           positions at or past the length and never reads them.
//           The products run on the tensor cores (mma.sync m16n8k16, bf16
//           in, fp32 out): the rep query rows padded to 16 are the A
//           operand, K (ldmatrix) and V (ldmatrix.trans) the B operands, P
//           rounded to bf16 from the score registers. The tensor cores have
//           the padded rows' work to spare, and the CUDA cores would spend
//           a conversion and a shared load on every element instead. Each
//           warp keeps its own (m, l, acc) over 16 positions of every tile,
//           so a tile needs no cross-warp reduction; the four warps merge
//           once, at the end, and the block writes its fp32 partial (m, l,
//           acc) for its rep rows into a scratch the caller allocates.
//   pass 2  fd_merge_kernel: each output row sums its slot's live splits in
//           split order (bit-identical across launches, no atomics); a split
//           that starts at or past the length has weight 0 and is never
//           read, so a slot of length 0 gives exactly 0. Its scratch, B * Hq
//           * splits * (D + 2) fp32 (1.3 MB for 16 Mistral slots), stays in
//           the L2 between the passes.
//
// What is left between this design and the bound (PERF.md): pass 2's own
// launch and the blocks' start-up and drain, which a short chunk does not
// amortise.
//
// The f32 instance (the tests' and the checks' exact reference) and bf16 at
// other head dims or rep > 16 keep the first, serial design below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "split_kv.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // positions staged per iteration
constexpr int kMaxD = 256;         // head_dim bound of the register prefetch

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// -- the serial design: f32, and bf16 shapes outside the split instances ----
//
// One block of 256 threads per (KV head, slot) walks the live positions in
// tiles of 32: the next tile's bytes are loaded into registers while the
// current one is scored, and tiles live in shared memory as f32 rows padded
// by 4 floats, so the per-(row, position) dot products and the P.V sums read
// conflict-free float4s.
//
// Shared memory, all f32, every region 16-byte aligned:
//   q_s [rep*d]         query rows of this KV head, pre-scaled by 1/sqrt(d)
//   acc [rep*d]         un-normalised output accumulator
//   k_s [kTile*(d+4)]   K tile, rows padded by 4 floats
//   v_s [kTile*(d+4)]   V tile
//   p_s [rep*kTile]     scores, then probabilities
//   m_s, l_s, c_s [rep] running max, running sum, this tile's correction
template <typename T>
__global__ void __launch_bounds__(kThreads)
fd_serial_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                 const T* __restrict__ v_cache,
                 const int* __restrict__ lengths, T* __restrict__ out, int hq,
                 int hkv, int d, int smax, long long stride_b,
                 long long stride_s, float scale) {
  static_assert(kTile == 32, "the softmax maps one lane per position");
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  // 16-byte vectors one thread holds for a tile at d <= kMaxD
  constexpr int kRegs = kTile * kMaxD / kVec / kThreads;
  const int h = blockIdx.x;              // KV head
  const int b = blockIdx.y;              // slot
  const int tid = threadIdx.x;
  const int rep = hq / hkv;
  const int ld = d + 4;                  // padded tile row stride
  const int d4 = d / 4;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* acc = q_s + rep * d;
  float* k_s = acc + rep * d;
  float* v_s = k_s + kTile * ld;
  float* p_s = v_s + kTile * ld;
  float* m_s = p_s + rep * kTile;
  float* l_s = m_s + rep;
  float* c_s = l_s + rep;

  // The cache row holds smax positions; nothing past them exists.
  const int length = min(max(lengths[b], 0), smax);
  const T* q_row = q + (static_cast<size_t>(b) * hq + h * rep) * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    q_s[i] = to_f(q_row[i]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const T* k_row = k_cache + b * stride_b + static_cast<long long>(h) * d;
  const T* v_row = v_cache + b * stride_b + static_cast<long long>(h) * d;
  const int vec_per_row = d / kVec;
  uint4 kr[kRegs], vr[kRegs];

  // Start the global loads of the tile at `start` into registers. Only live
  // positions are read.
  auto fetch = [&](int start) {
    const int n = min(kTile, length - start) * vec_per_row;
#pragma unroll
    for (int u = 0; u < kRegs; ++u) {
      const int i = tid + u * kThreads;
      if (i < n) {
        const long long off =
            static_cast<long long>(start + i / vec_per_row) * stride_s +
            (i % vec_per_row) * kVec;
        kr[u] = *reinterpret_cast<const uint4*>(k_row + off);
        vr[u] = *reinterpret_cast<const uint4*>(v_row + off);
      }
    }
  };
  // Widen the fetched registers to f32 in the shared tiles.
  auto stage = [&](int start) {
    const int n = min(kTile, length - start) * vec_per_row;
#pragma unroll
    for (int u = 0; u < kRegs; ++u) {
      const int i = tid + u * kThreads;
      if (i < n) {
        const int p = i / vec_per_row;
        const int c = (i % vec_per_row) * kVec;
        const T* ke = reinterpret_cast<const T*>(&kr[u]);
        const T* ve = reinterpret_cast<const T*>(&vr[u]);
        float4* kd = reinterpret_cast<float4*>(k_s + p * ld + c);
        float4* vd = reinterpret_cast<float4*>(v_s + p * ld + c);
#pragma unroll
        for (int g = 0; g < kVec / 4; ++g) {
          kd[g] = make_float4(to_f(ke[4 * g]), to_f(ke[4 * g + 1]),
                              to_f(ke[4 * g + 2]), to_f(ke[4 * g + 3]));
          vd[g] = make_float4(to_f(ve[4 * g]), to_f(ve[4 * g + 1]),
                              to_f(ve[4 * g + 2]), to_f(ve[4 * g + 3]));
        }
      }
    }
  };

  if (length > 0) fetch(0);
  for (int start = 0; start < length; start += kTile) {
    const int valid = min(kTile, length - start);  // live positions, > 0
    __syncthreads();  // previous tile fully consumed (and q_s/acc ready)
    stage(start);
    __syncthreads();
    if (start + kTile < length) fetch(start + kTile);  // in flight below

    // Scores: one thread per (query row, position), float4 dot products.
    for (int i = tid; i < rep * valid; i += kThreads) {
      const int r = i / valid;
      const int p = i % valid;
      const float4* qr = reinterpret_cast<const float4*>(q_s + r * d);
      const float4* kp = reinterpret_cast<const float4*>(k_s + p * ld);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int j = 0; j < d4; ++j) {
        const float4 a = qr[j];
        const float4 c = kp[j];
        s0 += a.x * c.x;
        s1 += a.y * c.y;
        s2 += a.z * c.z;
        s3 += a.w * c.w;
      }
      p_s[r * kTile + p] = (s0 + s1) + (s2 + s3);
    }
    __syncthreads();

    // Online softmax update: one warp per query row.
    for (int r = warp; r < rep; r += kWarps) {
      float* pr = p_s + r * kTile;
      const float s = lane < valid ? pr[lane] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float e = lane < valid ? expf(s - m_new) : 0.f;
      pr[lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = corr * acc + P V, four output dims per thread step.
    for (int i = tid; i < rep * d4; i += kThreads) {
      const int r = i / d4;
      const int j = (i % d4) * 4;
      const float* pr = p_s + r * kTile;
      float4* a4 = reinterpret_cast<float4*>(acc + r * d + j);
      const float corr = c_s[r];
      float4 a = *a4;
      a.x *= corr;
      a.y *= corr;
      a.z *= corr;
      a.w *= corr;
      for (int p = 0; p < valid; ++p) {
        const float w = pr[p];
        const float4 v = *reinterpret_cast<const float4*>(v_s + p * ld + j);
        a.x += w * v.x;
        a.y += w * v.y;
        a.z += w * v.z;
        a.w += w * v.w;
      }
      *a4 = a;
    }
  }
  __syncthreads();

  T* o_row = out + (static_cast<size_t>(b) * hq + h * rep) * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    const float l = l_s[i / d];
    o_row[i] = from_f<T>(l > 0.f ? acc[i] / l : 0.f);
  }
}

// -- bf16 split-KV: the serving path ------------------------------------------
// (its PTX wrappers, per-warp step and merges are split_kv.cuh's, shared
// with K1)

template <int kD>
constexpr size_t split_smem() {  // the ring; the end-of-block merge reuses it
  return static_cast<size_t>(kStages) * 2 * kSplitTile * (kD + 8) *
         sizeof(__nv_bfloat16);
}
static_assert(4 * kMaxRep * (2 + 64) * sizeof(float) <= split_smem<64>(),
              "the warps' partials fit in the ring");
static_assert(4 * kMaxRep * (2 + 128) * sizeof(float) <= split_smem<128>(),
              "the warps' partials fit in the ring");

// Pass 1. Block -> (split s, KV head h, slot b), the split slowest, so the
// splits every live slot has start first and the blocks of splits past short
// lengths, which exit at once, come last. Warp w scores positions 16w..16w+15
// of every 64-position tile of the chunk: S (16 padded rows x 16 positions)
// = Q K^T over kD/16 k-steps, then P V over one k-step of 16 positions and
// kD/8 n-tiles. Scores live in the log2 domain (pre-scaled by
// log2(e)/sqrt(D)); positions past the length score -inf, on the tile that
// holds the length only. Shared tiles are [64 positions][kD + 8] bf16: the
// 16-byte pad puts the 8 rows of an ldmatrix on distinct banks.
//
// Partials, fp32: part_acc[((b * Hkv + h) * splits + s) * rep + r][kD] (the
// un-normalised sum) and part_ml[... r][2] (m in the log2 domain, l).
template <int kD>
__global__ void __launch_bounds__(kSplitThreads)
fd_split_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k_cache,
                const __nv_bfloat16* __restrict__ v_cache,
                const int* __restrict__ lengths, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int nb, int hq, int hkv,
                int smax, long long stride_b, long long stride_s, int splits,
                int chunk, float sl2) {
  constexpr int TK = kSplitTile, kLd = kD + 8, kTileE = TK * kLd;
  constexpr int KK = kD / 16, ND = kD / 8, kVpr = kD / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int s = static_cast<int>(blockIdx.x) / (hkv * nb);
  const int h = static_cast<int>(blockIdx.x) % hkv;
  const int b = (static_cast<int>(blockIdx.x) / hkv) % nb;
  const int rep = hq / hkv;
  const int length = min(max(lengths[b], 0), smax);
  const int c0 = s * chunk;
  if (c0 >= length) return;  // an empty split: the merge never reads it
  const int c1 = min(c0 + chunk, length);
  const int n_tiles = (c1 - c0 + TK - 1) / TK;

  extern __shared__ uint4 smem16[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem16);
  const __nv_bfloat16* kb = k_cache + b * stride_b +
                            static_cast<long long>(h) * kD;
  const __nv_bfloat16* vb = v_cache + b * stride_b +
                            static_cast<long long>(h) * kD;
  // tile j of the chunk into ring stage `st`: K, then V
  auto load = [&](int j, int st) {
    const int p0 = c0 + j * TK, n = c1 - p0;
    __nv_bfloat16* kd = ring + 2 * st * kTileE;
    __nv_bfloat16* vd = kd + kTileE;
#pragma unroll
    for (int u = 0; u < TK * kVpr / kSplitThreads; ++u) {
      const int i = threadIdx.x + u * kSplitThreads;
      const int r = i / kVpr, c = (i % kVpr) * 8;
      const bool ok = r < n;
      const long long off = ok ? (p0 + r) * stride_s + c : 0;
      cp_async16(kd + r * kLd + c, kb + off, ok);
      cp_async16(vd + r * kLd + c, vb + off, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load(j, j);
    cp_async_commit();
  }

  // the rep query rows of head h as A fragments, rows >= rep zero
  uint32_t qa[KK][4];
  {
    const __nv_bfloat16* qr =
        q + (static_cast<long long>(b) * hq + h * rep) * kD;
    const bool ok0 = g < rep, ok8 = g + 8 < rep;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int c = kk * 16 + 2 * t;
      auto ld = [&](bool ok, int row, int col) {
        return ok ? *reinterpret_cast<const uint32_t*>(qr + row * kD + col)
                  : 0u;
      };
      qa[kk][0] = ld(ok0, g, c);
      qa[kk][1] = ld(ok8, g + 8, c);
      qa[kk][2] = ld(ok0, g, c + 8);
      qa[kk][3] = ld(ok8, g + 8, c + 8);
    }
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m8 = kNegInf, l0 = 0.f, l8 = 0.f;
  // ldmatrix row addresses of this lane within a tile: K (plain) gives the
  // B fragments of n-tiles 16w and 16w+8 for one k-step; V (trans) those of
  // two 8-column n-tiles for the warp's 16 positions
  const int k_row = 16 * warp + lane % 8 + 8 * (lane / 16);
  const int k_col = 8 * ((lane / 8) % 2);
  const int v_row = 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
  const int v_col = 8 * (lane / 16);

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j has landed (this thread's part)
    __syncthreads();               // ... everyone's; stage (j-1) is free
    {
      const int jn = j + kStages - 1;
      if (jn < n_tiles) load(jn, jn % kStages);
      cp_async_commit();
    }
    const __nv_bfloat16* kt = ring + 2 * (j % kStages) * kTileE;
    const __nv_bfloat16* vt = kt + kTileE;

    float sc[2][4];
    score_step<kD>(sc, qa, kt + k_row * kLd + k_col);
    // positions past the length only on the tile that holds it
    const int p0 = c0 + j * TK + 16 * warp;
    const bool edge = c0 + j * TK + TK > c1;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] *= sl2;
        if (edge && p0 + 8 * n + 2 * t + (e & 1) >= c1)
          sc[n][e] = -__int_as_float(0x7f800000);
      }
    softmax_pv_step<kD, false>(sc, m0, m8, l0, l8, o,
                               vt + v_row * kLd + v_col, nullptr);
  }

  // merge the four warps' (m, l, acc) in warp order; the ring is free
  cp_async_wait<0>();
  __syncthreads();
  float* ml_s = reinterpret_cast<float*>(smem16);  // [4][16][2]
  float* acc_s = ml_s + 4 * kMaxRep * 2;           // [4][rep][kD]
  stash_warp<kD>(ml_s, acc_s, rep, m0, l0, m8, l8, o);
  __syncthreads();
  const long long row0 =
      ((static_cast<long long>(b) * hkv + h) * splits + s) * rep;
  for (int i = threadIdx.x; i < rep * kD; i += kSplitThreads) {
    const int r = i / kD, c = i % kD;
    float big, sl;
    part_acc[row0 * kD + i] = merge_warps<kD>(ml_s, acc_s, rep, r, c, big, sl);
    if (c == 0) {
      part_ml[(row0 + r) * 2] = big;
      part_ml[(row0 + r) * 2 + 1] = sl;
    }
  }
}

// Pass 2: one thread per 4 output columns of a (slot, q head) row merges
// the slot's live splits in split order, in one pass (a running max, the
// sum rescaled as it grows); small blocks spread it over the SMs.
constexpr int kMergeThreads = 64;

template <int kD>
__global__ void __launch_bounds__(kMergeThreads)
fd_merge_kernel(const float* __restrict__ part_acc,
                const float* __restrict__ part_ml,
                const int* __restrict__ lengths,
                __nv_bfloat16* __restrict__ out, int nb, int hq, int hkv,
                int smax, int splits, int chunk) {
  constexpr int kC4 = kD / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(nb) * hq * kC4) return;
  const int c = static_cast<int>(i % kC4) * 4;
  const int row = static_cast<int>(i / kC4);  // b * hq + q head
  const int qh = row % hq, b = row / hq;
  const int rep = hq / hkv, h = qh / rep, r = qh % rep;
  const int length = min(max(lengths[b], 0), smax);
  const int n_live = (length + chunk - 1) / chunk;
  const long long base = (static_cast<long long>(b) * hkv + h) * splits;
  merge_splits<kD>(part_acc, part_ml, base * rep + r, rep, n_live, c,
                   out + static_cast<long long>(row) * kD);
}

template <int kD>
cudaError_t launch_split(const void* q, const void* k_cache,
                         const void* v_cache, const void* lengths, void* out,
                         void* scratch, int b, int hq, int hkv, int smax,
                         long long stride_b, long long stride_s, int splits,
                         int chunk, cudaStream_t stream) {
  auto kern = fd_split_kernel<kD>;
  const size_t smem = split_smem<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + static_cast<long long>(b) * hq * splits * kD;
  const unsigned blocks = static_cast<unsigned>(splits) * hkv * b;
  kern<<<blocks, kSplitThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache),
      static_cast<const int*>(lengths), part_acc, part_ml, b, hq, hkv, smax,
      stride_b, stride_s, splits, chunk,
      kLog2e / sqrtf(static_cast<float>(kD)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(b) * hq * (kD / 4);
  fd_merge_kernel<kD><<<static_cast<unsigned>((n + kMergeThreads - 1) /
                                              kMergeThreads),
                        kMergeThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), b, hq, hkv, smax, splits, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_serial(const void* q, const void* k_cache,
                          const void* v_cache, const void* lengths, void* out,
                          int b, int hq, int hkv, int d, int smax,
                          long long stride_b, long long stride_s, size_t smem,
                          cudaStream_t stream) {
  auto kern = fd_serial_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(lengths),
      static_cast<T*>(out), hq, hkv, d, smax, stride_b, stride_s,
      1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

size_t serial_smem(int rep, int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(rep) * d +
          2 * static_cast<size_t>(kTile) * (d + 4) +
          static_cast<size_t>(rep) * kTile + 3 * static_cast<size_t>(rep));
}

bool split_ok(int hq, int hkv, int d, int dtype) {
  return dtype == 1 && (d == 64 || d == 128) && hq / hkv <= kMaxRep;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, for q, both caches and out alike. q and out are
// contiguous (B, Hq, D); the caches are (B, Smax, Hkv, D) with the (Hkv, D)
// tail contiguous and the given B and position strides, in elements. Needs
// d % 4 == 0, d <= 256, and every pointer, stride and row of d elements
// 16-byte aligned (the caller checks).
//
// scratch == nullptr runs the serial design. Otherwise (bf16, D 64 or 128,
// Hq / Hkv <= 16: swi_flash_decode_splits says so) the split design with
// `splits` chunks of `chunk` positions (chunk % 64 == 0, splits * chunk >=
// smax), and scratch holds B * Hq * splits * (D + 2) f32.
//
// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int swi_flash_decode(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* out, void* scratch, int b, int hq,
                                int hkv, int d, int smax, long long stride_b,
                                long long stride_s, int splits, int chunk,
                                int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || d % 4 != 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    if (!split_ok(hq, hkv, d, dtype) || splits <= 0 || chunk <= 0 ||
        chunk % kSplitTile != 0 ||
        static_cast<long long>(splits) * chunk < smax)
      return static_cast<int>(cudaErrorInvalidValue);
    if (d == 64)
      return static_cast<int>(launch_split<64>(
          q, k_cache, v_cache, lengths, out, scratch, b, hq, hkv, smax,
          stride_b, stride_s, splits, chunk, s));
    return static_cast<int>(launch_split<128>(
        q, k_cache, v_cache, lengths, out, scratch, b, hq, hkv, smax,
        stride_b, stride_s, splits, chunk, s));
  }
  const size_t smem = serial_smem(hq / hkv, d);
  if (dtype == 0)
    return static_cast<int>(launch_serial<float>(
        q, k_cache, v_cache, lengths, out, b, hq, hkv, d, smax, stride_b,
        stride_s, smem, s));
  if (dtype == 1)
    return static_cast<int>(launch_serial<__nv_bfloat16>(
        q, k_cache, v_cache, lengths, out, b, hq, hkv, d, smax, stride_b,
        stride_s, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 when (hq, hkv, d, dtype) takes the split design, else 0.
extern "C" int swi_flash_decode_splits(int hq, int hkv, int d, int dtype) {
  return hkv > 0 && hq % hkv == 0 && split_ok(hq, hkv, d, dtype) ? 1 : 0;
}

// Shared memory bytes one launch needs, so the caller can refuse shapes the
// card cannot hold before launching.
extern "C" long long swi_flash_decode_smem(int hq, int hkv, int d,
                                           int dtype) {
  if (swi_flash_decode_splits(hq, hkv, d, dtype))
    return static_cast<long long>(d == 64 ? split_smem<64>()
                                          : split_smem<128>());
  return static_cast<long long>(serial_smem(hq / hkv, d));
}
