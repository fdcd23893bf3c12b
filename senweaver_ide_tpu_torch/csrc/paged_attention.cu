// Paged flash-decode for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel senweaver_ide_tpu/ops/paged_attention.py::
// _pfd_kernel (public function paged_flash_decode). For each entry t of a
// flat token batch and each of its Hq query heads it computes Sq=1
// attention over positions [0, lengths[t]) of the entry's sequence, reading
// position p at pool[tables[t, p / BS], p % BS, head / rep]. Softmax is
// online, in fp32, with scale 1/sqrt(D). Logical blocks at or past
// ceil(lengths[t] / BS) are never read, so dead table entries may hold any
// id. A row with lengths[t] == 0 writes zeros. With k_scale/v_scale
// (NB, BS, Hkv) f32, an int8 or fp8-e4m3 payload is upcast to fp32 and
// multiplied by its scale right after loading; a quantized block is never
// written back at full width.
//
// What bounds it: at Sq=1 each KV byte read feeds two multiply-adds per
// query row that shares its KV head (rep = Hq/Hkv, 6 for Qwen2.5-Coder-1.5B),
// far below the ~295 operations per byte at which the H100's compute
// becomes the limit. The work is bound by the bytes of KV it reads. The
// design therefore reads every live KV byte exactly once per (token,
// KV head): one CUDA block per (token, KV head) holds the rep query rows of
// that head in shared memory, so the GQA group shares each K/V tile instead
// of re-reading it per query head, and the tile is staged with 16-byte
// loads. Quantized pools move 1 byte per element plus one f32 scale per
// (position, head) instead of 2 bytes, and dequantization happens in
// registers on the way into shared memory.
//
// Design: one CUDA block of 256 threads per (token, KV head) walks the
// sequence in tiles of 32 positions. The next tile's K/V bytes are loaded
// into registers while the current tile is scored, so DRAM latency overlaps
// the math; tiles live in shared memory as f32 rows padded by 4 floats, so
// the per-(row, position) dot products and the P.V sums read them as
// conflict-free float4s. No split-KV across blocks yet (a long sequence is
// walked by one block), no TMA, no tensor cores: those are later levers.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // positions staged per iteration
constexpr int kMaxD = 256;         // head_dim bound of the register prefetch
constexpr float kNegInf = -1e30f;  // finite, as in the reference kernel

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

}  // namespace

// q_dtype: 0 = f32, 1 = bf16. kv_dtype: 0 = f32, 1 = bf16, 2 = int8 (with
// scales), 3 = fp8 e4m3 (with scales). Needs d % 4 == 0, d <= 256 and
// d * sizeof(payload) % 16 == 0 (the caller checks). Returns the
// cudaError_t of the launch (0 on success). Launches on `stream` and does
// not synchronise.
extern "C" int swi_paged_flash_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, int t, int hq, int hkv, int d, int bs,
    int mb, int q_dtype, int kv_dtype, void* stream) {
  if (t <= 0 || hkv <= 0 || hq % hkv != 0 || d % 4 != 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(hq / hkv, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// Shared memory bytes one launch needs, so the caller can refuse shapes the
// card cannot hold before launching.
extern "C" long long swi_paged_flash_decode_smem(int hq, int hkv, int d) {
  return static_cast<long long>(smem_bytes(hq / hkv, d));
}
