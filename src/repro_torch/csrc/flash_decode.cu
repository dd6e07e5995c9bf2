// Flash decode for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode.py::flash_decode (body `_kernel`).  It
// computes the same function: attention of one query token over a padded KV
// cache, q (B,Hq,D), k and v (B,C,Hk,D), lengths (B,) int32 -> o (B,Hq,D) in
// q's dtype, where the g = Hq/Hk query heads of a group read one K/V head and
// only the cache slots j < lengths[b] count:
//
//   s[h,j] = (q_h . k_j) / sqrt(D)   in f32
//   o_h    = sum_{j < len} softmax_j(s[h,:len]) v_j
//
// with the online softmax of the TPU kernel: a running max m, running sum l
// and accumulator acc per query head, all f32, and o = acc / max(l, 1e-30).
//
// What bounds it on this card.  One query token streams the valid part of
// the cache once: at the serving shape (B=8, Hq=32, Hk=8, D=128, bf16, all
// 1024 slots valid) k and v are 33.5 MB, 10.0 us at 3.35 TB/s, against
// 4*D*Hq*sum(len) = 1.3e8 operations (0.14 us at the bf16 peak): it is bound
// by bytes.  Reading each K/V tile once for all g heads of its group is what
// keeps it there; the TPU kernel's layout does the same.
//
// What the design does about it (simple and right first; fast is later work).
//  * Split over C.  The TPU grid (B, Hk, kv_blocks) walks the kv blocks in
//    order on one core, with m, l and acc in VMEM.  On Hopper (B, Hk) alone
//    is 64 blocks at the serving shape, for 132 SMs, and each would stream
//    its whole cache row alone.  So the cache axis is cut into splits of
//    `split_keys` slots (a multiple of the 64-slot tile, chosen by the
//    wrapper so that the grid holds a few blocks per SM): one block owns one
//    (b, kv head, split), holds the g grouped queries and keeps the f32 m, l
//    and acc of its part.  A second small pass merges the parts of each
//    (b, q head) by their maxima, the split-K reduction the JAX docstring
//    names as the GPU formulation.
//  * The empty tail.  A split that starts at or beyond lengths[b] returns at
//    once and the merge never reads it: slots past the length are never
//    loaded (the TPU kernel reads and masks them).
//  * Any C.  A ragged last tile is loaded as zeros past its end and masked,
//    so C need not be a multiple of the tile.
//  * Loads.  K and V tiles are read in 16-byte vectors, neighbouring threads
//    on neighbouring addresses, converted to f32 in shared memory (k rows
//    padded to D + 4 floats so the float4 reads of a quarter-warp hit
//    distinct banks).  Both products are f32 FMAs; no rounding of P, so the
//    f32 instantiation is full f32.  cp.async or TMA pipelining of the tiles
//    and keeping them in bf16 are the steps that make it faster.
//
// Lengths are taken in [1, C]: a length above C counts as C, and a length
// below 1 gives a zero output (the reference has no meaning for it).  The
// kernels allocate nothing and launch on the stream they are given; the C
// entry point returns cudaGetLastError() and the Python wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;   // cache slots per tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes from p (16-byte aligned) as floats
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 x = __bfloat1622float2(h[t]);
    f[2 * t] = x.x;
    f[2 * t + 1] = x.y;
  }
}

// floats of dynamic shared memory for g grouped heads at head size D: the
// queries, the k tile (rows padded to D + 4), the v tile, the scores, the
// accumulators and m, l, alpha per head
__host__ __device__ constexpr int smem_floats(int g, int D) {
  return g * D + kBK * (D + 4) + kBK * D + g * kBK + g * D + 3 * g;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ lengths,
                          float* __restrict__ part_acc, float* __restrict__ part_ml,
                          int C, int Hq, int Hk, int split_keys, float scale) {
  static_assert(D % 32 == 0, "head size");
  constexpr int PD = D + 4;                // padded row stride of the k tile
  constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int VPR = D / VEC;             // vectors per row

  const int g = Hq / Hk;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], C);
  const int k_begin = split * split_keys;
  if (k_begin >= len) return;              // the empty tail: never read
  const int k_end = min(k_begin + split_keys, len);

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (g, D)
  float* k_s = q_s + g * D;                      // (kBK, PD)
  float* v_s = k_s + kBK * PD;                   // (kBK, D)
  float* p_s = v_s + kBK * D;                    // (g, kBK) scores, then weights
  float* acc_s = p_s + g * kBK;                  // (g, D)
  float* m_s = acc_s + g * D;                    // (g)
  float* l_s = m_s + g;                          // (g)
  float* a_s = l_s + g;                          // (g) rescale of this tile

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  // the group's g query heads are g * D neighbouring elements of q
  const T* qg = q + ((long long)b * Hq + (long long)hk * g) * D;
  for (int e = tid; e < g * D; e += kThreads) {
    q_s[e] = to_f32(qg[e]);
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const long long row = (long long)Hk * D;     // slot stride of k and v
  const long long kv_off = (long long)b * C * row + (long long)hk * D;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, k_end - k0);       // valid slots in this tile
    __syncthreads();  // the previous tile is done with k_s, v_s and p_s
    for (int idx = tid; idx < kBK * VPR; idx += kThreads) {
      const int r = idx / VPR, c = (idx % VPR) * VEC;
      float kf[VEC], vf[VEC];
      if (r < nk) {
        const long long gi = kv_off + (k0 + r) * row + c;
        load16(k + gi, kf);
        load16(v + gi, vf);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) kf[t] = vf[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        k_s[r * PD + c + t] = kf[t];
        v_s[r * D + c + t] = vf[t];
      }
    }
    __syncthreads();

    // 1) scores: thread owns slot j = tid % kBK of heads tid / kBK + 2i
    for (int pi = tid; pi < g * kBK; pi += kThreads) {
      const int i = pi / kBK, j = pi % kBK;
      const float* qr = q_s + i * D;
      const float* kr = k_s + j * PD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qr + d);
        const float4 kb = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(qa.x, kb.x, s);
        s = fmaf(qa.y, kb.y, s);
        s = fmaf(qa.z, kb.z, s);
        s = fmaf(qa.w, kb.w, s);
      }
      p_s[pi] = j < nk ? s * scale : kNegInf;
    }
    __syncthreads();

    // 2) the online softmax update, one warp per head, two slots a lane
    for (int i = warp; i < g; i += kWarps) {
      const float s0 = p_s[i * kBK + lane], s1 = p_s[i * kBK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = lane < nk ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < nk ? expf(s1 - m_new) : 0.f;
      p_s[i * kBK + lane] = p0;
      p_s[i * kBK + lane + 32] = p1;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + rs;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // 3) acc = alpha * acc + P V: thread owns elements tid + 128r of (g, D)
    for (int e = tid; e < g * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const float* pr = p_s + i * kBK;
      float a = acc_s[e] * a_s[i];
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
      acc_s[e] = a;
    }
  }
  __syncthreads();

  const long long part = (long long)(b * Hk + hk) * gridDim.x + split;
  for (int e = tid; e < g * D; e += kThreads) part_acc[part * g * D + e] = acc_s[e];
  for (int i = tid; i < g; i += kThreads) {
    part_ml[(part * g + i) * 2] = m_s[i];
    part_ml[(part * g + i) * 2 + 1] = l_s[i];
  }
}

// One block per (q head, b): merges the used splits of that head by their
// maxima and writes o.
template <typename T>
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_acc,
                                          const float* __restrict__ part_ml,
                                          const int* __restrict__ lengths,
                                          T* __restrict__ o, int C, int Hq, int Hk,
                                          int D, int split_keys, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = Hq / Hk, hk = h / g, i = h % g;
  const int len = min(lengths[b], C);
  T* out = o + ((long long)b * Hq + h) * D;
  if (len < 1) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) store_as(out + d, 0.f);
    return;
  }
  const int used = (len + split_keys - 1) / split_keys;
  const long long base = (long long)(b * Hk + hk) * nsplit;
  float M = kNegInf;
  for (int s = 0; s < used; ++s) M = fmaxf(M, part_ml[((base + s) * g + i) * 2]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f, L = 0.f;
    for (int s = 0; s < used; ++s) {
      const long long p = (base + s) * g + i;
      const float w = expf(part_ml[p * 2] - M);
      L = fmaf(w, part_ml[p * 2 + 1], L);
      acc = fmaf(w, part_acc[p * D + d], acc);
    }
    store_as(out + d, acc / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* o, float* part_acc, float* part_ml, int B, int C, int Hq,
                   int Hk, int split_keys, int nsplit, float scale, cudaStream_t st) {
  const int smem = smem_floats(Hq / Hk, D) * (int)sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_decode_split_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_decode_split_kernel<T, D><<<dim3(nsplit, Hk, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, part_acc, part_ml, C, Hq, Hk, split_keys, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_merge_kernel<T><<<dim3(Hq, B), D, 0, st>>>(
      part_acc, part_ml, lengths, static_cast<T*>(o), C, Hq, Hk, D, split_keys, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* lengths,
                     void* o, float* part_acc, float* part_ml, int B, int C, int Hq,
                     int Hk, int D, int split_keys, int nsplit, float scale,
                     cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, lengths, o, part_acc, part_ml, B, C, Hq, Hk,
                                  split_keys, nsplit, scale, st);
    case 64: return launch<T, 64>(q, k, v, lengths, o, part_acc, part_ml, B, C, Hq, Hk,
                                  split_keys, nsplit, scale, st);
    case 128: return launch<T, 128>(q, k, v, lengths, o, part_acc, part_ml, B, C, Hq, Hk,
                                    split_keys, nsplit, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, Hq, D); k, v: (B, C, Hk, D); all float32 (is_bf16 = 0) or all
// bfloat16 (is_bf16 = 1), contiguous and 16-byte aligned; lengths: (B,)
// int32.  part_acc: (B, Hk, nsplit, g, D) and part_ml: (B, Hk, nsplit, g, 2)
// float32 scratch, with nsplit * split_keys >= C and split_keys a multiple
// of 64.  D in {32, 64, 128}, Hq % Hk == 0, Hk and B at most 65535.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* part_acc,
                                void* part_ml, int B, int C, int Hq, int Hk, int D,
                                int split_keys, int nsplit, float scale, int is_bf16,
                                void* stream) {
  if (B < 1 || C < 1 || Hq < 1 || Hk < 1 || Hq % Hk != 0 || B > 65535 || Hk > 65535 ||
      split_keys < kBK || split_keys % kBK != 0 || nsplit < 1 ||
      (long long)nsplit * split_keys < C)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, len, o, pa, pm, B, C, Hq, Hk, D, split_keys,
                                   nsplit, scale, st);
  return dispatch<float>(q, k, v, len, o, pa, pm, B, C, Hq, Hk, D, split_keys, nsplit,
                         scale, st);
}

// Dynamic shared memory one block of the split pass takes for g grouped
// heads at head size D, in bytes.
extern "C" int flash_decode_smem_bytes(int g, int D) {
  return smem_floats(g, D) * (int)sizeof(float);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
