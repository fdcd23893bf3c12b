// Paged flash-decode for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel senweaver_ide_tpu/ops/paged_attention.py::
// _pfd_kernel (public function paged_flash_decode). For each entry t of a
// flat token batch and each of its Hq query heads it computes Sq=1
// attention over positions [0, lengths[t]) of the entry's sequence, reading
// position p at pool[tables[t, p / BS], p % BS, head / rep]. Softmax is
// online, in fp32, with scale 1/sqrt(D). Positions at or past the length
// are never read, so dead table entries may hold any id. A row with
// lengths[t] == 0 writes zeros. With k_scale/v_scale (NB, BS, Hkv) f32, the
// pool holds int8 or fp8-e4m3 payloads; a quantized block is never written
// back at full width.
//
// What bounds it: at Sq=1 each KV byte read feeds two multiply-adds per
// query row that shares its KV head (rep = Hq/Hkv, 6 for Qwen2.5-Coder-1.5B),
// far below the ~295 operations per byte at which the H100's compute
// becomes the limit, so the work is bound by the bytes of KV it reads:
// 17.8 MB for 16 decode rows of 128..2048 positions at bf16, 5.3 us at
// 3.35 TB/s.
//
// The bf16-q design (bf16, int8 and fp8 pools, D 64 and 128, rep <= 16:
// every model the port serves) is split-KV in two passes, through the
// block table. Against the four limits of the first design (one block per
// (entry, KV head), which left 32 blocks on 132 SMs at a 16-row decode
// step; one tile in flight in registers; tiles widened to fp32 with four
// barriers each; products on the CUDA cores; and every chunked-prefill
// token re-reading its sequence's prefix):
//
//   query tiles  The optional tile list groups consecutive entries that
//           read the same table row (a chunked-prefill segment: positions
//           p, p+1, ...) into one tile of at most 16 query rows (entries x
//           rep: 2 entries at rep 6), one m16 A operand. A tile's block
//           stages each KV tile once for all its rows and masks each row at
//           its own length, so a 40-token segment of a 1024-token prompt
//           reads its prefix 20 times, not 40. Tiles of up to 64 rows (four
//           row blocks, each warp walking a KV tile's 64 positions alone)
//           read it 4 times but measured slower on the mixed step
//           (PERF.md). The wrapper checks a tile list on the host; with no
//           list, each entry is its own tile.
//   pass 1  pfd_split_kernel: one block of 4 warps per (split, KV head,
//           query tile). The split plan comes from shapes only (tiles, Hkv,
//           MB * BS, SM count: ops/flash_decode.py::split_plan) on the host,
//           so the lengths stay on the device; a block whose chunk starts
//           at or past its tile's longest length exits at once. A block
//           reads its physical block ids from its table row itself, one KV
//           tile ahead of the copies that use them (there is no scalar
//           prefetch on this card), and copies each 64-position tile (four
//           pool blocks of BS 16; each position row of one KV head is D x
//           elt bytes, at a stride of Hkv * D * elt) with 16-byte cp.async
//           at its stored width into a two-stage ring with one barrier a
//           tile. cp.async zero-fills positions at or past the tile's
//           longest length and never reads them.
//           The products run on the tensor cores: mma.sync m16n8k16, bf16
//           in, fp32 out, the tile's query rows padded to 16 as the A
//           operand, K by ldmatrix and V by ldmatrix.trans as B operands,
//           P rounded to bf16 from the score registers. wgmma's 64-row A
//           tile would pad a 6-row decode tile about ten times over, and
//           at Sq=1 the work is bound by bytes: mma.sync's 16 rows are
//           padding the tensor cores have to spare.
//           Warp w takes positions 16w..16w+15 of every KV tile for all
//           the tile's rows and keeps its own (m, l, acc), so a tile needs
//           no cross-warp reduction; the four warps merge once, at the end,
//           in warp order, and the block writes each row's fp32 partial
//           (m, l, acc) into a scratch the caller allocates.
//           int8 and fp8 pools copy their 1-byte payloads and f32 scales
//           through the same table indirection, which halves the bytes
//           read against bf16; one pass a tile converts the payloads to
//           bf16 (exact for int8 and e4m3 values) for ldmatrix (one more
//           barrier a tile), and the scales apply in fp32: K's scale
//           multiplies its score column, V's folds into P before P.V.
//   pass 2  pfd_merge_kernel: each output row sums its entry's live splits
//           in split order (bit-identical across launches, no atomics); a
//           split at or past the entry's own length is never read, so a
//           row of length 0 gives exactly 0.
//
// What is left between this design and the bound (PERF.md): pass 2's own
// launch, the blocks' start-up and drain at short chunks, the table-id
// loads on each block's critical path, and uneven work over the SMs where
// lengths are ragged.
//
// The f32 instances (the tests' exact reference) and any other shape keep
// the first, serial design below (pfd_kernel): one block of 256 threads per
// (entry, KV head) walks the sequence in 32-position tiles widened to fp32
// in shared memory, the next tile's bytes in registers.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
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
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ float to_f<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
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

// Shared memory, all f32, every region 16-byte aligned:
//   q_s [rep*d]         query rows of this KV head, pre-scaled by 1/sqrt(d)
//   acc [rep*d]         un-normalised output accumulator
//   k_s [kTile*(d+4)]   dequantized K tile, rows padded by 4 floats
//   v_s [kTile*(d+4)]   dequantized V tile
//   p_s [rep*kTile]     scores, then probabilities
//   m_s, l_s, c_s [rep] running max, running sum, this tile's correction
template <typename QT, typename KT, bool kQuant>
__global__ void __launch_bounds__(kThreads)
pfd_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
           const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, const int* __restrict__ tables,
           const int* __restrict__ lengths, QT* __restrict__ out, int hq,
           int hkv, int d, int bs, int mb, float scale) {
  static_assert(kTile == 32, "the softmax maps one lane per position");
  constexpr int kVec = 16 / sizeof(KT);  // elements per 16-byte load
  // 16-byte vectors one thread holds for a tile at d <= kMaxD
  constexpr int kRegs = kTile * kMaxD / kVec / kThreads;
  const int h = blockIdx.x;              // KV head
  const int t = blockIdx.y;              // token entry
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

  // A table row addresses at most mb * bs positions; the gather reference
  // sees no more than that either.
  const int length = min(lengths[t], mb * bs);
  const QT* q_row = q + (static_cast<size_t>(t) * hq + h * rep) * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    q_s[i] = to_f(q_row[i]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int* tbl = tables + static_cast<size_t>(t) * mb;
  const int vec_per_row = d / kVec;
  uint4 kr[kRegs], vr[kRegs];
  float ksr[kRegs], vsr[kRegs];

  // Issue the global loads of the tile at `start` into registers. Only
  // live positions are read, through the block table.
  auto fetch = [&](int start) {
    const int n = min(kTile, length - start) * vec_per_row;
#pragma unroll
    for (int u = 0; u < kRegs; ++u) {
      const int i = tid + u * kThreads;
      if (i < n) {
        const int pos = start + i / vec_per_row;
        const int c = (i % vec_per_row) * kVec;
        const int phys = tbl[pos / bs];
        const size_t row =
            (static_cast<size_t>(phys) * bs + (pos % bs)) * hkv + h;
        kr[u] = *reinterpret_cast<const uint4*>(k_pool + row * d + c);
        vr[u] = *reinterpret_cast<const uint4*>(v_pool + row * d + c);
        if (kQuant) {
          ksr[u] = k_scale[row];
          vsr[u] = v_scale[row];
        }
      }
    }
  };
  // Dequantize the fetched registers into the shared tiles.
  auto stage = [&](int start) {
    const int n = min(kTile, length - start) * vec_per_row;
#pragma unroll
    for (int u = 0; u < kRegs; ++u) {
      const int i = tid + u * kThreads;
      if (i < n) {
        const int p = i / vec_per_row;
        const int c = (i % vec_per_row) * kVec;
        const KT* ke = reinterpret_cast<const KT*>(&kr[u]);
        const KT* ve = reinterpret_cast<const KT*>(&vr[u]);
        float4* kd = reinterpret_cast<float4*>(k_s + p * ld + c);
        float4* vd = reinterpret_cast<float4*>(v_s + p * ld + c);
#pragma unroll
        for (int g = 0; g < kVec / 4; ++g) {
          float kf[4], vf[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kf[e] = to_f(ke[4 * g + e]);
            vf[e] = to_f(ve[4 * g + e]);
            if (kQuant) {
              kf[e] *= ksr[u];
              vf[e] *= vsr[u];
            }
          }
          kd[g] = make_float4(kf[0], kf[1], kf[2], kf[3]);
          vd[g] = make_float4(vf[0], vf[1], vf[2], vf[3]);
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
        const float4 b = kp[j];
        s0 += a.x * b.x;
        s1 += a.y * b.y;
        s2 += a.z * b.z;
        s3 += a.w * b.w;
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

  QT* o_row = out + (static_cast<size_t>(t) * hq + h * rep) * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    const float l = l_s[i / d];
    o_row[i] = from_f<QT>(l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename QT, typename KT, bool kQuant>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* lengths, void* out, int t,
                   int hq, int hkv, int d, int bs, int mb, size_t smem,
                   cudaStream_t stream) {
  auto kern = pfd_kernel<QT, KT, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(hkv, t);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), hq, hkv, d, bs,
      mb, 1.0f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* tables,
                        const void* lengths, void* out, int t, int hq, int hkv,
                        int d, int bs, int mb, size_t smem,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float, false>(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, lengths, out, t, hq, hkv, d, bs,
                                      mb, smem, stream);
    case 1:
      return launch<QT, __nv_bfloat16, false>(
          q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, t, hq,
          hkv, d, bs, mb, smem, stream);
    case 2:
      return launch<QT, int8_t, true>(q, k_pool, v_pool, k_scale, v_scale,
                                      tables, lengths, out, t, hq, hkv, d, bs,
                                      mb, smem, stream);
    case 3:
      return launch<QT, __nv_fp8_e4m3, true>(
          q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, t, hq,
          hkv, d, bs, mb, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t smem_bytes(int rep, int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(rep) * d +
          2 * static_cast<size_t>(kTile) * (d + 4) +
          static_cast<size_t>(rep) * kTile + 3 * static_cast<size_t>(rep));
}

// -- bf16 q, split-KV through the block table: the serving path ------------
// (its PTX wrappers, per-warp step and merges are split_kv.cuh's, shared
// with K3)

constexpr int kIdSlots = 3;  // table-id slots: the tile being read, the
                             // next, and the one after it
// Resident blocks an SM the split pass is built for: its shared memory
// (about 70 KB) leaves room for three, and without the bound the bf16
// instance takes 202 registers and two (PERF.md).
constexpr int kSplitBlocksPerSm = 3;

// The same copy as cp_async16 for one 4-byte scale.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Shared memory of pass 1, in bytes, every region 16-byte aligned:
//   ring   [kStages][K, V][64 positions][kRawLd]  payload rows as stored,
//          padded by 16 bytes so the 8 rows of an ldmatrix fall on
//          distinct banks
//   conv   [K, V][64][kD + 8] bf16                quantized pools only: the
//          tile converted for ldmatrix
//   scales [kStages][K, V][64] f32                quantized pools only
//   ids    [kIdSlots][64] int                     physical block of each
//          position of a tile
// After the walk the end-of-block merge reuses the bytes before `ids`:
//   ml [4 warps][16 rows][2] f32, acc [4 warps][rows <= 16][kD] f32.
template <int kD, typename KT>
struct SplitSmem {
  static constexpr bool kQuant = sizeof(KT) == 1;
  static constexpr int kRawLd = kD * static_cast<int>(sizeof(KT)) + 16;
  static constexpr int kLd = kD + 8;
  static constexpr size_t kRing =
      static_cast<size_t>(kStages) * 2 * kSplitTile * kRawLd;
  static constexpr size_t kConv =
      kQuant ? 2 * static_cast<size_t>(kSplitTile) * kLd * 2 : 0;
  static constexpr size_t kScales =
      kQuant ? static_cast<size_t>(kStages) * 2 * kSplitTile * 4 : 0;
  static constexpr size_t kWalk = kRing + kConv + kScales;
  static constexpr size_t kMerge = (4 * kMaxRep * 2 + 4 * kMaxRep * kD) * 4;
  static constexpr size_t kIds = kWalk > kMerge ? kWalk : kMerge;
  static constexpr size_t kBytes = kIds + kIdSlots * kSplitTile * 4;
};

// Sixteen 1-byte payloads to sixteen bf16 (exact for int8 and e4m3).
template <typename KT>
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo,
                                        uint4& hi) {
  const KT* e = reinterpret_cast<const KT*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = pack_f2(to_f(e[2 * k]), to_f(e[2 * k + 1]));
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

// Pass 1. Block -> (split s, KV head h, query tile qt), the split slowest,
// so the splits every live tile has start first and the blocks of splits
// past short lengths, which exit at once, come last. Query tile qt is
// entries [e0, e0 + n) (tiles[2 qt], tiles[2 qt + 1], which the wrapper
// checked on the host: n * rep <= 16; without a tile list, entry qt
// alone), all read through table row e0; its rows are r = j * rep + i for
// entry e0 + j and q head h * rep + i, padded to one m16 A operand. Warp w
// scores positions 16w..16w+15 of every 64-position tile for all of them.
// Scores live in the log2 domain (pre-scaled by log2(e)/sqrt(D), and by K's
// scale on quantized pools); a row's positions at or past its own length
// score -inf, on the steps past the tile's shortest length only.
//
// Partials, fp32, one row per (entry, q head, split):
// part_acc[(e * Hq + qh) * splits + s][kD] (the un-normalised sum) and
// part_ml[...][2] (m in the log2 domain, l).
template <int kD, typename KT>
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocksPerSm)
pfd_split_kernel(const __nv_bfloat16* __restrict__ q,
                 const KT* __restrict__ k_pool, const KT* __restrict__ v_pool,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ tables,
                 const int* __restrict__ lengths,
                 const int* __restrict__ tiles, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int n_qtiles, int hq, int hkv,
                 int bs, int mb, int splits, int chunk, float sl2) {
  using L = SplitSmem<kD, KT>;
  constexpr int TK = kSplitTile, KK = kD / 16, ND = kD / 8;
  constexpr int kRowBytes = kD * static_cast<int>(sizeof(KT));
  constexpr int kVpr = kRowBytes / 16;  // 16-byte copies a position row
  constexpr int kLd = L::kLd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bid = static_cast<int>(blockIdx.x);
  const int s = bid / (hkv * n_qtiles);
  const int h = bid % hkv;
  const int qt = (bid / hkv) % n_qtiles;
  const int rep = hq / hkv;
  int e0 = qt, n = 1;
  if (tiles != nullptr) {
    e0 = tiles[2 * qt];
    n = tiles[2 * qt + 1];
  }
  const int rows = n * rep;  // <= kMaxRep
  const int cap = mb * bs;   // a table row addresses no more positions
  int lo = cap, hi = 0;      // the tile's shortest and longest length
  for (int j = 0; j < n; ++j) {
    const int len = min(max(lengths[e0 + j], 0), cap);
    lo = min(lo, len);
    hi = max(hi, len);
  }
  const int c0 = s * chunk;
  if (c0 >= hi) return;  // an empty split: the merge never reads it
  const int c1 = min(c0 + chunk, hi);
  const int n_tiles = (c1 - c0 + TK - 1) / TK;

  extern __shared__ uint4 smem16[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem16);
  unsigned char* ring = smem;
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem + L::kRing);
  float* scales = reinterpret_cast<float*>(smem + L::kRing + L::kConv);
  int* ids = reinterpret_cast<int*>(smem + L::kIds);
  const int* tbl = tables + static_cast<long long>(e0) * mb;
  const unsigned char* kbytes =
      reinterpret_cast<const unsigned char*>(k_pool);
  const unsigned char* vbytes =
      reinterpret_cast<const unsigned char*>(v_pool);

  // the physical block of position `tid` of tile j (threads 0..63)
  auto fetch_id = [&](int j) {
    const int p = c0 + j * TK + tid;
    return tid < TK && j < n_tiles && p < c1 ? tbl[p / bs] : 0;
  };
  // tile j into ring stage `st`: K, then V, then (quantized) the scales
  auto load = [&](int j, int st) {
    const int p0 = c0 + j * TK, nv = c1 - p0;
    const int* id = ids + (j % kIdSlots) * TK;
    unsigned char* kd = ring + static_cast<size_t>(2 * st) * TK * L::kRawLd;
    unsigned char* vd = kd + TK * L::kRawLd;
#pragma unroll
    for (int u = 0; u < TK * kVpr / kSplitThreads; ++u) {
      const int i = tid + u * kSplitThreads;
      const int r = i / kVpr, c = (i % kVpr) * 16;
      const bool ok = r < nv;
      long long off = 0;
      if (ok) {
        const int p = p0 + r;
        off = ((static_cast<long long>(id[r]) * bs + p % bs) * hkv + h) *
                  kRowBytes + c;
      }
      cp_async16(kd + r * L::kRawLd + c, kbytes + off, ok);
      cp_async16(vd + r * L::kRawLd + c, vbytes + off, ok);
    }
    if constexpr (L::kQuant) {
      const int r = tid % TK;
      const bool ok = r < nv;
      long long off = 0;
      if (ok) {
        const int p = p0 + r;
        off = (static_cast<long long>(id[r]) * bs + p % bs) * hkv + h;
      }
      float* dst = scales + (2 * st + (tid < TK ? 0 : 1)) * TK;
      cp_async4(dst + r, (tid < TK ? k_scale : v_scale) + off, ok);
    }
  };

  if (tid < TK) {
    ids[tid] = fetch_id(0);
    ids[TK + tid] = fetch_id(1);
  }
  int id_next = fetch_id(2);
  __syncthreads();
  load(0, 0);
  cp_async_commit();

  // this lane's two rows g and g + 8: A fragments (zero past the tile's
  // rows) and lengths (padding rows take the tile's longest)
  auto row_len = [&](int r) {
    return r < rows ? min(max(lengths[e0 + r / rep], 0), cap) : hi;
  };
  const int len0 = row_len(g), len8 = row_len(g + 8);
  uint32_t qa[KK][4];
  {
    auto qrow = [&](int r) {
      const int rr = r < rows ? r : 0;
      return q + (static_cast<long long>(e0 + rr / rep) * hq + h * rep +
                  rr % rep) * kD;
    };
    const __nv_bfloat16* q0 = qrow(g);
    const __nv_bfloat16* q8 = qrow(g + 8);
    const bool ok0 = g < rows, ok8 = g + 8 < rows;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const int c = kk * 16 + 2 * t;
      auto ld = [&](bool ok, const __nv_bfloat16* p, int col) {
        return ok ? *reinterpret_cast<const uint32_t*>(p + col) : 0u;
      };
      qa[kk][0] = ld(ok0, q0, c);
      qa[kk][1] = ld(ok8, q8, c);
      qa[kk][2] = ld(ok0, q0, c + 8);
      qa[kk][3] = ld(ok8, q8, c + 8);
    }
  }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = kNegInf, m8 = kNegInf, l0 = 0.f, l8 = 0.f;
  // ldmatrix row offsets of this lane within a tile: K (plain) gives the B
  // fragments of n-tiles 16w and 16w+8 for one k-step; V (trans) those of
  // two 8-column n-tiles for the warp's 16 positions
  const int k_row = 16 * warp + lane % 8 + 8 * (lane / 16);
  const int k_col = 8 * ((lane / 8) % 2);
  const int v_row = 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
  const int v_col = 8 * (lane / 16);

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j has landed (this thread's part)
    if (tid < TK) ids[((j + 2) % kIdSlots) * TK + tid] = id_next;
    __syncthreads();  // ... everyone's; stage (j-1) and its ids are free
    if (j + 1 < n_tiles) load(j + 1, (j + 1) % kStages);
    cp_async_commit();
    id_next = fetch_id(j + 3);

    const int st = j % kStages;
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    const float* ks = scales + 2 * st * TK;
    const float* vs = ks + TK;
    if constexpr (L::kQuant) {
      const unsigned char* raw =
          ring + static_cast<size_t>(2 * st) * TK * L::kRawLd;
#pragma unroll
      for (int u = 0; u < 2 * TK * kVpr / kSplitThreads; ++u) {
        const int i = tid + u * kSplitThreads;  // K rows, then V rows
        const int r = i / kVpr, c = (i % kVpr) * 16;
        uint4 lo4, hi4;
        widen16<KT>(*reinterpret_cast<const uint4*>(raw + r * L::kRawLd + c),
                    lo4, hi4);
        uint4* dst = reinterpret_cast<uint4*>(conv + r * kLd + c);
        dst[0] = lo4;
        dst[1] = hi4;
      }
      __syncthreads();
      kt = conv;
      vt = conv + TK * kLd;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(
          ring + static_cast<size_t>(2 * st) * TK * L::kRawLd);
      vt = kt + TK * kLd;
    }
    const int p0 = c0 + j * TK + 16 * warp;  // this warp's first position
    if (p0 >= c1) continue;  // all zero-filled, past the chunk's end
    float sc[2][4];
    score_step<kD>(sc, qa, kt + k_row * kLd + k_col);
    const bool edge = p0 + 16 > lo;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = 16 * warp + 8 * nn + 2 * t + (e & 1);
        if constexpr (L::kQuant)
          sc[nn][e] *= sl2 * ks[pos];
        else
          sc[nn][e] *= sl2;
        if (edge && c0 + j * TK + pos >= (e < 2 ? len0 : len8))
          sc[nn][e] = -__int_as_float(0x7f800000);
      }
    softmax_pv_step<kD, L::kQuant>(sc, m0, m8, l0, l8, o,
                                   vt + v_row * kLd + v_col,
                                   vs + 16 * warp + 2 * t);
  }

  // merge the four warps' (m, l, acc) in warp order; the ring is free
  cp_async_wait<0>();
  __syncthreads();
  float* ml_s = reinterpret_cast<float*>(smem);  // [4][16][2]
  float* acc_s = ml_s + 4 * kMaxRep * 2;         // [4][rows][kD]
  stash_warp<kD>(ml_s, acc_s, rows, m0, l0, m8, l8, o);
  __syncthreads();
  for (int i = tid; i < rows * kD; i += kSplitThreads) {
    const int r = i / kD, c = i % kD;
    float big, sl;
    const float acc = merge_warps<kD>(ml_s, acc_s, rows, r, c, big, sl);
    const long long prow =
        (static_cast<long long>(e0 + r / rep) * hq + h * rep + r % rep) *
            splits + s;
    part_acc[prow * kD + c] = acc;
    if (c == 0) {
      part_ml[prow * 2] = big;
      part_ml[prow * 2 + 1] = sl;
    }
  }
}

// Pass 2: one thread per 4 output columns of an (entry, q head) row merges
// the entry's live splits in split order (split_kv.cuh's merge_splits);
// small blocks spread it over the SMs.
constexpr int kMergeThreads = 64;

template <int kD>
__global__ void __launch_bounds__(kMergeThreads)
pfd_merge_kernel(const float* __restrict__ part_acc,
                 const float* __restrict__ part_ml,
                 const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, int n_entries, int hq,
                 int cap, int splits, int chunk) {
  constexpr int kC4 = kD / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(n_entries) * hq * kC4) return;
  const int c = static_cast<int>(i % kC4) * 4;
  const int row = static_cast<int>(i / kC4);  // entry * hq + q head
  const int length = min(max(lengths[row / hq], 0), cap);
  const int n_live = (length + chunk - 1) / chunk;
  merge_splits<kD>(part_acc, part_ml, static_cast<long long>(row) * splits,
                   1, n_live, c, out + static_cast<long long>(row) * kD);
}

struct SplitArgs {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *lengths,
      *tiles;
  void *out, *scratch;
  int t, n_qtiles, hq, hkv, bs, mb, splits, chunk;
};

template <int kD, typename KT>
cudaError_t launch_split(const SplitArgs& a, cudaStream_t stream) {
  auto kern = pfd_split_kernel<kD, KT>;
  const size_t smem = SplitSmem<kD, KT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* part_acc = static_cast<float*>(a.scratch);
  float* part_ml =
      part_acc + static_cast<long long>(a.t) * a.hq * a.splits * kD;
  const unsigned blocks =
      static_cast<unsigned>(a.splits) * a.hkv * a.n_qtiles;
  kern<<<blocks, kSplitThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const KT*>(a.k_pool), static_cast<const KT*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      static_cast<const int*>(a.tiles), part_acc, part_ml, a.n_qtiles, a.hq,
      a.hkv, a.bs, a.mb, a.splits, a.chunk,
      kLog2e / sqrtf(static_cast<float>(kD)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(a.t) * a.hq * (kD / 4);
  pfd_merge_kernel<kD><<<static_cast<unsigned>((n + kMergeThreads - 1) /
                                               kMergeThreads),
                         kMergeThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<const int*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.t, a.hq, a.mb * a.bs, a.splits,
      a.chunk);
  return cudaGetLastError();
}

template <int kD>
cudaError_t dispatch_split(int kv_dtype, const SplitArgs& a,
                           cudaStream_t stream) {
  switch (kv_dtype) {
    case 1:
      return launch_split<kD, __nv_bfloat16>(a, stream);
    case 2:
      return launch_split<kD, int8_t>(a, stream);
    case 3:
      return launch_split<kD, __nv_fp8_e4m3>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool split_ok(int hq, int hkv, int d, int q_dtype, int kv_dtype) {
  return hkv > 0 && hq % hkv == 0 && q_dtype == 1 && kv_dtype >= 1 &&
         kv_dtype <= 3 && (d == 64 || d == 128) && hq / hkv <= kMaxRep;
}

template <int kD>
size_t split_smem(int kv_dtype) {
  return kv_dtype == 1 ? SplitSmem<kD, __nv_bfloat16>::kBytes
                       : SplitSmem<kD, int8_t>::kBytes;
}

template <typename K>
cudaError_t occupancy_of(K kern, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      kSplitThreads, smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem);
  out[2] = kSplitThreads;
  out[3] = blocks;
  return err;
}

template <int kD>
cudaError_t split_occupancy(int kv_dtype, int* out) {
  switch (kv_dtype) {
    case 1:
      return occupancy_of(pfd_split_kernel<kD, __nv_bfloat16>,
                          SplitSmem<kD, __nv_bfloat16>::kBytes, out);
    case 2:
      return occupancy_of(pfd_split_kernel<kD, int8_t>,
                          SplitSmem<kD, int8_t>::kBytes, out);
    case 3:
      return occupancy_of(pfd_split_kernel<kD, __nv_fp8_e4m3>,
                          SplitSmem<kD, __nv_fp8_e4m3>::kBytes, out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = f32, 1 = bf16. kv_dtype: 0 = f32, 1 = bf16, 2 = int8 (with
// scales), 3 = fp8 e4m3 (with scales). Needs d % 4 == 0, d <= 256 and
// d * sizeof(payload) % 16 == 0 (the caller checks).
//
// scratch == nullptr runs the serial design, which reads every entry alone
// and ignores `tiles`. Otherwise (bf16 q on a bf16, int8 or fp8 pool, D 64
// or 128, Hq / Hkv <= 16: swi_paged_flash_decode_splits says so) the split
// design with `splits` chunks of `chunk` positions (chunk % 64 == 0, splits
// * chunk >= mb * bs) over `n_qtiles` query tiles: `tiles` holds (first
// entry, count) pairs covering entries 0..t-1 in order, each tile's entries
// reading the same table row, count * (Hq / Hkv) <= 16; tiles == nullptr
// makes each entry its own tile (n_qtiles == t). scratch holds t * Hq *
// splits * (D + 2) f32.
//
// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int swi_paged_flash_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, const void* tiles, void* out, void* scratch, int t,
    int n_qtiles, int hq, int hkv, int d, int bs, int mb, int splits,
    int chunk, int q_dtype, int kv_dtype, void* stream) {
  if (t <= 0 || hkv <= 0 || hq % hkv != 0 || d % 4 != 0 || d > kMaxD ||
      bs <= 0 || mb <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    if (!split_ok(hq, hkv, d, q_dtype, kv_dtype) || splits <= 0 ||
        chunk <= 0 || chunk % kSplitTile != 0 ||
        static_cast<long long>(splits) * chunk <
            static_cast<long long>(mb) * bs ||
        n_qtiles <= 0 || (tiles == nullptr && n_qtiles != t))
      return static_cast<int>(cudaErrorInvalidValue);
    const SplitArgs a{q,     k_pool,  v_pool, k_scale,  v_scale, tables,
                      lengths, tiles, out,    scratch,  t,       n_qtiles,
                      hq,    hkv,     bs,     mb,       splits,  chunk};
    return static_cast<int>(d == 64 ? dispatch_split<64>(kv_dtype, a, s)
                                    : dispatch_split<128>(kv_dtype, a, s));
  }
  const size_t smem = smem_bytes(hq / hkv, d);
  cudaError_t err;
  if (q_dtype == 0)
    err = dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                             tables, lengths, out, t, hq, hkv, d, bs, mb,
                             smem, s);
  else if (q_dtype == 1)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, k_scale,
                                     v_scale, tables, lengths, out, t, hq, hkv,
                                     d, bs, mb, smem, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// 1 when (hq, hkv, d, q_dtype, kv_dtype) takes the split design, else 0.
extern "C" int swi_paged_flash_decode_splits(int hq, int hkv, int d,
                                             int q_dtype, int kv_dtype) {
  return split_ok(hq, hkv, d, q_dtype, kv_dtype) ? 1 : 0;
}

// Shared memory bytes one launch needs, so the caller can refuse shapes the
// card cannot hold before launching.
extern "C" long long swi_paged_flash_decode_smem(int hq, int hkv, int d,
                                                 int q_dtype, int kv_dtype) {
  if (split_ok(hq, hkv, d, q_dtype, kv_dtype))
    return static_cast<long long>(d == 64 ? split_smem<64>(kv_dtype)
                                          : split_smem<128>(kv_dtype));
  return static_cast<long long>(smem_bytes(hq / hkv, d));
}

// The split pass's resources as the card reports them, for a pool of
// kv_dtype (1 bf16, 2 int8, 3 fp8) at head dim d: out[4] = registers per
// thread, dynamic shared bytes per block, threads per block, resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int swi_paged_flash_decode_occupancy(int d, int kv_dtype,
                                                int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (d == 64)
    err = split_occupancy<64>(kv_dtype, out);
  else if (d == 128)
    err = split_occupancy<128>(kv_dtype, out);
  return static_cast<int>(err);
}
