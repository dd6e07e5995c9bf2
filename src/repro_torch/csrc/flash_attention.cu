// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body `_kernel`).  It
// computes the same function: causal (optionally windowed) or non-causal GQA
// attention, q (B,S,Hq,D) and k, v (B,S,Hk,D) -> o (B,S,Hq,D) in q's dtype,
// where the g = Hq/Hk query heads of a group read one K/V head:
//
//   s[i,j] = (q_i . k_j) / sqrt(D)   in f32, -1e30 where masked
//            (causal: j > i; window w: j <= i - w; ragged tail: j >= S)
//   o_i    = sum_j softmax_j(s[i,:]) v_j
//
// with the online softmax of the TPU kernel: a running max m, running sum l
// and accumulator acc per query row, all f32, and o = acc / max(l, 1e-30).
//
// What bounds it on this card.  At the training shape (B=4, S=2048, Hq=16,
// D=64, bf16, causal) it reads q, k, v and writes o once, 6.7e7 bytes (20 us
// at 3.35 TB/s), and does 4*D flops per unmasked (i, j) pair, 3.4e10 flops
// (35 us at the 989 TFLOP/s bf16 tensor-core peak): it is bound by
// operations.  The state per query row never leaves the chip, so the
// (S, S) score matrix is never written to device memory.
//
// What the design does about it (simple and right first; fast is later work).
//  * Blocks.  The TPU walks the kv blocks in order on one core with the
//    state in VMEM.  Here blocks run in no order on 132 SMs, so one block
//    owns a 64-row tile of queries of one (b, q head) and loops over the kv
//    tiles itself, with m and l in registers (each row's 16 threads keep a
//    copy), acc in registers and the tiles in shared memory: B*Hq*ceil(S/64)
//    blocks, 2048 at the training shape.  The heaviest causal tiles (the last
//    query rows) are launched first, so the tail of the grid is short.
//  * Pruning.  The loop runs only over the kv tiles the causal mask and the
//    window let in; wholly masked tiles are never loaded (the TPU kernel
//    visits them and masks everything).
//  * Ragged S.  Rows and keys past S are loaded as zeros and masked, so any
//    S >= 1 runs here; the TPU kernel needs S to divide by its block size.
//  * Arithmetic.  f32 FMAs from shared memory for both products, 4x4 score
//    and 4x(D/16) output register tiles per thread, float4 shared-memory
//    reads along the reduced axis (rows padded to a multiple of 4 floats off
//    the bank period, so a quarter-warp's 16-byte reads hit distinct banks).
//    No TF32 and no rounding of P, so the f32 instantiation is full f32.
//    Tensor cores (wgmma on bf16 tiles), TMA loads and a K/V tile shared by
//    the query heads of a group are the steps that make it fast.
//
// The kernel allocates nothing and launches on the stream it is given; the C
// entry point returns cudaGetLastError() and the Python wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per kv tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_floats() {
  // q and k tiles (rows padded to D + 4), v tile, p tile (rows padded to 68)
  return kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * (kBK + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Hq, int Hk, float scale, int causal, int window) {
  static_assert(D % 16 == 0, "head size");
  constexpr int PD = D + 4;     // padded row stride of the q and k tiles
  constexpr int PP = kBK + 4;   // padded row stride of the p tile
  constexpr int NC = D / 16;    // output columns per thread

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;             // (kBQ, PD)
  float* k_s = q_s + kBQ * PD;   // (kBK, PD)
  float* v_s = k_s + kBK * PD;   // (kBK, D)
  float* p_s = v_s + kBK * D;    // (kBQ, PP)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // thread owns rows ty + 16a
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;                 // b * Hq + h
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * kBQ;

  const long long q_row = (long long)Hq * D;   // token stride of q and o
  const long long kv_row = (long long)Hk * D;  // token stride of k and v
  const long long q_off = (long long)b * S * q_row + (long long)h * D;
  const long long kv_off = (long long)b * S * kv_row + (long long)hk * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    q_s[r * PD + d] = q0 + r < S ? to_f32(q[q_off + (q0 + r) * q_row + d]) : 0.f;
  }

  // kv tiles that hold a key some row of this tile may see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is done with k_s, v_s and p_s
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < S;
      const long long g = kv_off + (k0 + r) * kv_row + d;
      k_s[r * PD + d] = in ? to_f32(k[g]) : 0.f;
      v_s[r * D + d] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // 1) scores: thread (tx, ty) owns rows ty + 16a and keys tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(&q_s[(ty + 16 * a) * PD + d]);
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        kb[bb] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * bb) * PD + d]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          s[a][bb] = fmaf(qa[a].x, kb[bb].x, s[a][bb]);
          s[a][bb] = fmaf(qa[a].y, kb[bb].y, s[a][bb]);
          s[a][bb] = fmaf(qa[a].z, kb[bb].z, s[a][bb]);
          s[a][bb] = fmaf(qa[a].w, kb[bb].w, s[a][bb]);
        }
    }

    // 2) mask, then the online softmax update of each row this thread owns;
    //    a row's 16 threads are 16 neighbouring lanes of one warp
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty + 16 * a;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int kp = k0 + tx + 16 * bb;
        ok[bb] = kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[a][bb] = ok[bb] ? s[a][bb] * scale : kNegInf;
        mx = fmaxf(mx, s[a][bb]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const float p = ok[bb] ? expf(s[a][bb] - m_new) : 0.f;
        p_s[(ty + 16 * a) * PP + tx + 16 * bb] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * alpha + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

    // 3) acc += P V: thread owns rows ty + 16a and columns tx + 16c
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(&p_s[(ty + 16 * a) * PP + j]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float v0 = v_s[j * D + col], v1 = v_s[(j + 1) * D + col];
        const float v2 = v_s[(j + 2) * D + col], v3 = v_s[(j + 3) * D + col];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][c] = fmaf(pa[a].x, v0, acc[a][c]);
          acc[a][c] = fmaf(pa[a].y, v1, acc[a][c]);
          acc[a][c] = fmaf(pa[a].z, v2, acc[a][c]);
          acc[a][c] = fmaf(pa[a].w, v3, acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= S) continue;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_as(o + q_off + row * q_row + tx + 16 * c, acc[a][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Hq, int Hk, float scale, int causal, int window,
                   cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Hq, Hk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int S, int Hq, int Hk, int D, float scale, int causal,
                     int window, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, Hq, D); k, v: (B, S, Hk, D); all float32 (is_bf16 = 0) or all
// bfloat16 (is_bf16 = 1), contiguous.  D in {32, 64, 128}, Hq % Hk == 0,
// B * Hq <= 65535, any S >= 1.  window <= 0 means no window.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int Hq, int Hk, int D,
                                   float scale, int causal, int window,
                                   int is_bf16, void* stream) {
  if (B < 1 || S < 1 || Hq < 1 || Hk < 1 || Hq % Hk != 0 || B * Hq > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hk, D, scale, causal, window, st);
  return dispatch<float>(q, k, v, o, B, S, Hq, Hk, D, scale, causal, window, st);
}

// Dynamic shared memory one block takes at head size D, in bytes; -1 if D is
// not built.  ptxas -v reports static shared memory only.
extern "C" int flash_attention_smem_bytes(int D) {
  switch (D) {
    case 32: return smem_floats<32>() * (int)sizeof(float);
    case 64: return smem_floats<64>() * (int)sizeof(float);
    case 128: return smem_floats<128>() * (int)sizeof(float);
    default: return -1;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
