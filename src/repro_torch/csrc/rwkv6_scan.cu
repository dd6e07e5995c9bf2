// Chunked RWKV6 WKV scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan
// (body `_kernel`).  It computes the same function:
//
//   y_t = r_t . (S_{t-1} + u * k_t (x) v_t)
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//
// in chunks of c tokens (c = 64 or 16).  Per chunk, with cum the inclusive
// cumulative log-decay and cum_exc the exclusive one:
//
//   y       = (r * e^{cum_exc}) @ S  +  A @ v
//   A[t,i]  = sum_n r[t,n] k[i,n] e^{min(cum_exc[t,n] - cum[i,n], 0)}   (i < t)
//   A[t,t]  = sum_n r[t,n] u[n] k[t,n]
//   S      <- diag(e^{cum[c-1]}) S + (k * e^{cum[c-1] - cum})^T @ v
//
// with log(max(w, 1e-30)) and f32 arithmetic throughout, as on the TPU.
//
// What bounds it on this card.  Per head it reads O(T*N) values but does
// O(T*c*N) f32 work, an exponential in each term of A: at c = N = 64 that is
// far more operations per byte than the H100's f32 units sustain against
// 3.35 TB/s, so it is bound by f32 operations, not by memory.  And the TPU's
// grid (B, H, chunks) gives only B*H = 40 independent sequences at B = 1,
// too few for 132 SMs.
//
// What the design does about it.
//  * Blocks.  Column j of y and of S needs only column j of S and of v, so a
//    block owns one (b, h) and a 16-wide tile of v-columns, and loops over the
//    chunks in order with its S columns in shared memory: B*H*(N/16) blocks,
//    160 at B = 1, H = 40, N = 64.
//  * No (c, c, N) tensor.  The TPU kernel broadcasts the pairwise decay to an
//    explicit (c, c, N) f32 tensor, 1 MiB at c = N = 64, beyond the 227 KB of
//    shared memory a block has.  Here each thread accumulates a (c/16)^2
//    register tile of A over n, reading r, k and cum from shared memory rows
//    padded to N+1 floats so a warp's reads fall in distinct banks.
//  * A ragged last chunk is masked: r = k = v = 0 and log w = 0 past T, so
//    every T goes through the kernel.
// Each column tile recomputes A, four times the exponentials at N = 64: the
// first thing to remove when this kernel is made fast (A shared across a
// cluster of the four column blocks, tensor cores for the three products).
//
// The kernel allocates nothing and launches on the stream it is given; the C
// entry point returns cudaGetLastError() and the Python wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileV = 16;  // v-columns per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int C, int N>
constexpr int smem_floats() {
  return 3 * C * (N + 1) + C * (C + 1) + C * kTileV + N * kTileV + N;
}

template <typename T, int C, int N>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ sT, int T_len, int H) {
  static_assert(C % 16 == 0 && N % kTileV == 0, "tile shapes");
  constexpr int P = N + 1;   // padded row stride of the (C, N) tiles
  constexpr int PA = C + 1;  // padded row stride of A
  constexpr int R = C / 16;  // register tile of A per thread is R x R
  constexpr int NV = N / kTileV;

  extern __shared__ float smem[];
  float* r_s = smem;               // (C, P): r, then r * e^{cum_exc}
  float* k_s = r_s + C * P;        // (C, P): k, then k * e^{total - cum}
  float* c_s = k_s + C * P;        // (C, P): log w, then its inclusive cumsum
  float* a_s = c_s + C * P;        // (C, PA): A
  float* v_s = a_s + C * PA;       // (C, kTileV)
  float* s_s = v_s + C * kTileV;   // (N, kTileV): this block's columns of S
  float* u_s = s_s + N * kTileV;   // (N)

  const int tid = threadIdx.x;
  const int tile = blockIdx.x % NV;
  const int bh = blockIdx.x / NV;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int j0 = tile * kTileV;

  const long long row = (long long)H * N;                   // token stride
  const long long base = ((long long)b * T_len * H + h) * N;  // (b, 0, h, 0)
  const float* s0_bh = s0 + (long long)bh * N * N;
  float* sT_bh = sT + (long long)bh * N * N;

  for (int idx = tid; idx < N * kTileV; idx += kThreads)
    s_s[idx] = s0_bh[(idx / kTileV) * N + j0 + idx % kTileV];
  for (int n = tid; n < N; n += kThreads) u_s[n] = u[h * N + n];

  const int tx = tid % 16, ty = tid / 16;

  for (int t0 = 0; t0 < T_len; t0 += C) {
    const int len = min(C, T_len - t0);
    __syncthreads();  // the previous chunk is done with every tile

    // 1) load the chunk; rows past T are masked to r = k = v = 0, log w = 0
    for (int idx = tid; idx < C * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      float rv = 0.f, kv = 0.f, lw = 0.f;
      if (t < len) {
        const long long g = base + (t0 + t) * row + n;
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        lw = logf(fmaxf(w[g], 1e-30f));
      }
      r_s[t * P + n] = rv;
      k_s[t * P + n] = kv;
      c_s[t * P + n] = lw;
    }
    for (int idx = tid; idx < C * kTileV; idx += kThreads) {
      const int t = idx / kTileV, j = idx % kTileV;
      v_s[idx] = t < len ? to_f32(v[base + (t0 + t) * row + j0 + j]) : 0.f;
    }
    __syncthreads();

    // 2) inclusive cumulative log-decay over the chunk, one channel a thread
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += c_s[t * P + n];
        c_s[t * P + n] = acc;
      }
    }
    __syncthreads();

    // 3) A, accumulated over n: thread (tx, ty) owns rows ty + 16a and
    //    columns tx + 16b, so every warp has work on both sides of the diagonal
    {
      float acc[R][R];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int bb = 0; bb < R; ++bb) acc[a][bb] = 0.f;
      for (int n = 0; n < N; ++n) {
        float rt[R], ce[R], kk[R], cm[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const int t = ty + 16 * a;
          rt[a] = r_s[t * P + n];
          ce[a] = t > 0 ? c_s[(t - 1) * P + n] : 0.f;  // cum_exc[t, n]
        }
#pragma unroll
        for (int bb = 0; bb < R; ++bb) {
          const int i = tx + 16 * bb;
          kk[bb] = k_s[i * P + n];
          cm[bb] = c_s[i * P + n];
        }
        const float un = u_s[n];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int bb = 0; bb < R; ++bb) {
            const int t = ty + 16 * a, i = tx + 16 * bb;
            if (i < t)
              acc[a][bb] += rt[a] * kk[bb] * expf(fminf(ce[a] - cm[bb], 0.f));
            else if (i == t)
              acc[a][bb] += rt[a] * un * kk[bb];
          }
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int bb = 0; bb < R; ++bb) {
          const int t = ty + 16 * a, i = tx + 16 * bb;
          a_s[t * PA + i] = i <= t ? acc[a][bb] : 0.f;
        }
    }
    __syncthreads();

    // 4) r <- r * e^{cum_exc},  k <- k * e^{total - cum}  (factors <= 1)
    for (int idx = tid; idx < C * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const float ce = t > 0 ? c_s[(t - 1) * P + n] : 0.f;
      const float total = c_s[(C - 1) * P + n];
      r_s[t * P + n] *= expf(ce);
      k_s[t * P + n] *= expf(total - c_s[t * P + n]);
    }
    __syncthreads();

    // 5) y = (r * e^{cum_exc}) @ S + A @ v
    for (int idx = tid; idx < C * kTileV; idx += kThreads) {
      const int t = idx / kTileV, j = idx % kTileV;
      float acc = 0.f;
      for (int n = 0; n < N; ++n) acc += r_s[t * P + n] * s_s[n * kTileV + j];
      for (int i = 0; i <= t; ++i) acc += a_s[t * PA + i] * v_s[i * kTileV + j];
      if (t < len) store_as(y + base + (t0 + t) * row + j0 + j, acc);
    }
    __syncthreads();  // every y has read S before S is updated

    // 6) S <- diag(e^{total}) S + (k * e^{total - cum})^T @ v
    for (int idx = tid; idx < N * kTileV; idx += kThreads) {
      const int n = idx / kTileV, j = idx % kTileV;
      float acc = expf(c_s[(C - 1) * P + n]) * s_s[idx];
      for (int i = 0; i < C; ++i) acc += k_s[i * P + n] * v_s[i * kTileV + j];
      s_s[idx] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * kTileV; idx += kThreads)
    sT_bh[(idx / kTileV) * N + j0 + idx % kTileV] = s_s[idx];
}

template <typename T, int C, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* sT, int B,
                   int T_len, int H, cudaStream_t stream) {
  const int smem = smem_floats<C, N>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, C, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int blocks = B * H * (N / kTileV);
  rwkv6_scan_kernel<T, C, N><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(sT),
      T_len, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* s0, void* y, void* sT, int B,
                     int T_len, int H, int N, int chunk, cudaStream_t st) {
#define RWKV6_CASE(CC, NN)                                                     \
  if (chunk == CC && N == NN)                                                  \
    return launch<T, CC, NN>(r, k, v, w, u, s0, y, sT, B, T_len, H, st);
  RWKV6_CASE(64, 64)
  RWKV6_CASE(16, 64)
  RWKV6_CASE(64, 32)
  RWKV6_CASE(16, 32)
#undef RWKV6_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, y: (B, T, H, N) float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// w: (B, T, H, N) float32; u: (H, N) float32; s0, sT: (B, H, N, N) float32.
// All contiguous.  N in {32, 64}, chunk in {16, 64}, any T >= 1.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* sT, int B, int T_len, int H, int N,
                              int chunk, int is_bf16, void* stream) {
  if (B < 1 || T_len < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, B, T_len, H, N, chunk, st);
  return dispatch<float>(r, k, v, w, u, s0, y, sT, B, T_len, H, N, chunk, st);
}

// Dynamic shared memory one block takes at (N, chunk), in bytes; -1 if the
// pair is not built.  ptxas -v reports static shared memory only.
extern "C" int rwkv6_scan_smem_bytes(int N, int chunk) {
#define RWKV6_SMEM(CC, NN) \
  if (chunk == CC && N == NN) return smem_floats<CC, NN>() * (int)sizeof(float);
  RWKV6_SMEM(64, 64)
  RWKV6_SMEM(16, 64)
  RWKV6_SMEM(64, 32)
  RWKV6_SMEM(16, 32)
#undef RWKV6_SMEM
  return -1;
}

extern "C" const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
