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
// KV it reads. The design reads every live KV byte exactly once per
// (slot, KV head): one CUDA block per (slot, KV head) holds the rep query rows
// of that head in shared memory, so the group shares each K/V tile instead of
// re-reading it per query head, and tiles are staged with 16-byte loads.
//
// Unlike the TPU kernel, which keeps the whole Hkv axis in one grid step (a
// Mosaic tiling rule for blocks narrower than 8 heads), the grid here is
// (Hkv, B): the GPU has no such rule, and per-head blocks give B * Hkv
// independent blocks. That is 128 blocks for Mistral-7B at 16 slots but only
// 32 for Qwen2.5-Coder-1.5B at 16 slots, on 132 SMs; each block walks its
// slot's length serially. Split-KV (several blocks per slot, merged by a
// second pass) is the lever for the short grids and long rows, and is left
// for a later change, as are cp.async/TMA double buffering and tensor-core
// products.
//
// Design: one block of 256 threads walks the live positions in tiles of 32.
// The next tile's K/V bytes are loaded into registers while the current tile
// is scored, so device-memory latency overlaps the math; tiles live in shared
// memory as f32 rows padded by 4 floats, so the per-(row, position) dot
// products and the P.V sums read them as conflict-free float4s.

#include <cuda_bf16.h>
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
//   k_s [kTile*(d+4)]   K tile, rows padded by 4 floats
//   v_s [kTile*(d+4)]   V tile
//   p_s [rep*kTile]     scores, then probabilities
//   m_s, l_s, c_s [rep] running max, running sum, this tile's correction
template <typename T>
__global__ void __launch_bounds__(kThreads)
fd_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
          const T* __restrict__ v_cache, const int* __restrict__ lengths,
          T* __restrict__ out, int hq, int hkv, int d, int smax,
          long long stride_b, long long stride_s, float scale) {
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

template <typename T>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const void* lengths, void* out, int b, int hq, int hkv,
                   int d, int smax, long long stride_b, long long stride_s,
                   size_t smem, cudaStream_t stream) {
  auto kern = fd_kernel<T>;
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

size_t smem_bytes(int rep, int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(rep) * d +
          2 * static_cast<size_t>(kTile) * (d + 4) +
          static_cast<size_t>(rep) * kTile + 3 * static_cast<size_t>(rep));
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, for q, both caches and out alike. q and out are
// contiguous (B, Hq, D); the caches are (B, Smax, Hkv, D) with the (Hkv, D)
// tail contiguous and the given B and position strides, in elements. Needs
// d % 4 == 0, d <= 256, and every pointer, stride and row of d elements
// 16-byte aligned (the caller checks). Returns the cudaError_t of the launch
// (0 on success). Launches on `stream` and does not synchronise.
extern "C" int swi_flash_decode(const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths,
                                void* out, int b, int hq, int hkv, int d,
                                int smax, long long stride_b,
                                long long stride_s, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || d % 4 != 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(hq / hkv, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_cache, v_cache, lengths, out,
                                          b, hq, hkv, d, smax, stride_b,
                                          stride_s, smem, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k_cache, v_cache, lengths, out, b, hq, hkv, d, smax, stride_b,
        stride_s, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory bytes one launch needs, so the caller can refuse shapes the
// card cannot hold before launching.
extern "C" long long swi_flash_decode_smem(int hq, int hkv, int d) {
  return static_cast<long long>(smem_bytes(hq / hkv, d));
}
