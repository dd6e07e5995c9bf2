// Chunked RWKV6 WKV scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan
// (body `_kernel`).  It computes the same function:
//
//   y_t = r_t . (S_{t-1} + u * k_t (x) v_t)
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//
// in chunks of c = 32 tokens (the TPU kernel takes 64 or 16; the result is
// the same function, so every T uses 32 here, with a masked ragged last
// chunk).  Per chunk, with cum the inclusive cumulative log-decay, cum_exc
// the exclusive one and total = cum at the chunk's last token:
//
//   y       = (r * e^{cum_exc}) @ S  +  A @ v
//   A[t,i]  = sum_n r[t,n] k[i,n] e^{cum_exc[t,n] - cum[i,n]}   (i < t)
//   A[t,t]  = sum_n r[t,n] u[n] k[t,n]
//   S      <- diag(e^{total}) S + (k * e^{total - cum})^T @ v
//
// with log(max(w, 1e-30)) and f32 arithmetic throughout, as on the TPU (the
// logs are taken in base 2 and every exponential is an exp2: the same
// function).
//
// What bounds it on this card.  Per head it reads O(T*N) values and does
// O(T*N*N + T*c*N) work.  At B=1, T=512, H=40, N=64 in bf16, counted at
// c = 32 with the products at the TF32 peak, the work takes 3.4 us on the
// f32 SIMT pipe (the state update, A's diagonal blocks with an exponential
// a term) and 0.5 us on the tensor cores, and the 17 MB of r, k, v, w, y,
// S0 and S_T take 5.1 us at 3.35 TB/s: the bound is the bytes.  In practice
// what bounds it is how much of the work can run in parallel (only the
// N x N state carry is sequential over the chunks) and the latency of each
// block's long instruction stream.
//
// What the design does about it: three kernels, one launch each.
//  1. rwkv6_state_kernel, one block per (b, h, chunk), all in parallel:
//     the chunk's state increment dS = (k * e^{total - cum})^T @ v and its
//     decay e^{total}, into scratch the wrapper allocates
//     (B, H, chunks, N, N) and (B, H, chunks, N).
//  2. rwkv6_carry_kernel, one thread per (b, h, state element): walks the
//     chunks in order, S <- e^{total} S + dS, and overwrites each chunk's dS
//     with the state at the chunk's start; S_T at the end.  This elementwise
//     recurrence is all that stays sequential.
//  3. rwkv6_output_kernel, one block per (b, h, chunk), all in parallel: A
//     once per chunk (not once per column tile), then y = A @ v +
//     (r e^{cum_exc}) @ S_start for all N columns.
//  * A is factored over 16-token sub-chunks.  Only the diagonal 16x16
//    blocks keep an exponential per term, e^{min(cum_exc[t] - cum[i], 0)},
//    all in one pass over the block's threads.  A block below the
//    diagonal (rows in sub-chunk q, columns in sub-chunk p < q) is a
//    product of factors: with ref(p) the last token of sub-chunk p,
//      A[t,i] = sum_n (r e^{cum_exc - cum[ref(q-1)]})[t,n]
//                     e^{cum[ref(q-1)] - cum[ref(p)]}[n]
//                     (k e^{cum[ref(p)] - cum})[i,n],
//    the form (r e^{cum_exc - cum_ref}) (k e^{cum_ref - cum})^T with the row
//    factor chained through ref(q-1), so each row and each column of A
//    gets one factor and each (q, p) pair one vector.  Every factor is <= 1,
//    so nothing overflows; a factor that underflows to 0 stands for a
//    product that is smaller still.  Log-decays are summed within a
//    sub-chunk only, and a span across sub-chunks adds sub-chunk totals, so
//    no difference of two long prefix sums (which cancels in f32 under
//    strong decay) is formed.  Per 32 tokens the exponentials fall from
//    32 * 31 / 2 * N (per 64 tokens four times that again in the kernel this
//    one replaces, once per column tile) to 2 * 120 * N on the diagonal plus
//    a few thousand factors; the rest of A is a product.  The diagonal pass
//    has no branch in its loop: a branch per term serialised it, and it
//    took several times as long.
//  * 32-token chunks.  Each block's work is one long instruction stream
//    over 8 warps, so its time is latency, not throughput: 64-token chunks
//    gave half the blocks (80 at B=1, T=128, fewer than the SMs), each
//    nearly twice as long, and a slower output pass.
//  * Products.  In the bf16 instantiation the blocks of A below the
//    diagonal and y = A @ v + (r e^{cum_exc}) @ S run on the tensor cores
//    (mma.sync m16n8k8, TF32 operands, f32 accumulators); the f32
//    instantiation keeps SIMT FMAs in full f32.  The state update stays
//    SIMT in both (in TF32 it measured slower).
//  * Loads.  A thread issues all its 16-byte (f32) or 8-byte (bf16) loads of
//    a chunk before it stores any to shared memory.
//  * Loops over shared memory have trip counts fixed at compile time: nvcc
//    12.9 at -O3 was seen to run a per-thread loop `for (t = 16*s; t < 16*s +
//    16; ++t)` past its end at N = 64 (and a loop over a runtime range of
//    sub-chunks out of bounds), where the fixed-count form is right.
//  * Tiles live in shared memory as f32 rows padded to N + 1 floats, so the
//    column reads of a warp fall in distinct banks.
//  * A ragged last chunk is masked: r = k = v = 0 and log w = 0 past T, so
//    every T >= 1 runs.
//
// The kernels allocate nothing and launch on the stream they are given; the C
// entry point returns a cudaError_t and the Python wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;   // tokens a chunk
constexpr int kSub = 16;     // tokens a sub-chunk of A's factorisation
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8;   // chunks whose loads the carry issues together

// 2^x in one special-function instruction (about 2 ulp; a result below the
// smallest normal f32 flushes to 0, which only ever stands for a decay
// factor too small to count)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// c += a b on the tensor cores: m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: c[nt] (the 16 x 8 tile at rows 0..15, columns n0 + 8 nt) +=
// A[16 x 8 ks] B[8 ks x ...] for the first `ksteps` of KS k steps, f32 in
// shared memory: A(m, k) = A[m * lda + k], times ak[k] when ak is given;
// B(k, n) = B[k * ldb + n] (B[n * ldb + k] with TB).
// Lane (g, t) = (lane / 4, lane % 4) holds c[nt] at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
template <int KS, int NT, bool TB = false>
__device__ __forceinline__ void warp_mma(float (*c)[4], const float* A, int lda, const float* B,
                                         int ldb, int n0, int ksteps, int lane,
                                         const float* ak = nullptr) {
  const int g = lane >> 2, t = lane & 3;
  auto a_at = [&](int m, int k) {
    const float x = A[m * lda + k];
    return to_tf32(ak ? x * ak[k] : x);
  };
  auto b_at = [&](int k, int n) { return to_tf32(TB ? B[n * ldb + k] : B[k * ldb + n]); };
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks >= ksteps) break;   // the same for the whole warp
    const int k0 = 8 * ks;
    const uint32_t a[4] = {a_at(g, k0 + t), a_at(g + 8, k0 + t), a_at(g, k0 + t + 4),
                           a_at(g + 8, k0 + t + 4)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + 8 * nt + g;
      mma_tf32(c[nt], a, b_at(k0 + t, col), b_at(k0 + t + 4, col));
    }
  }
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int smem, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load() & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

template <int N>
constexpr int state_smem_floats() {
  return 3 * kChunk * (N + 1);                         // k, v, log w / cum
}
constexpr int kPairs = (kChunk / kSub) * (kChunk / kSub - 1) / 2;   // blocks below the diagonal
// Block j below A's diagonal is (rows in sub-chunk pair_q(j), columns in
// sub-chunk pair_p(j)), numbered (1, 0), (2, 0), (2, 1), (3, 0), ...; called
// with constants, folded at compile time.
__host__ __device__ constexpr int pair_q(int j, int q = 1) {
  return j < q ? q : pair_q(j - q, q + 1);
}
__host__ __device__ constexpr int pair_p(int j, int q = 1) {
  return j < q ? j : pair_p(j - q, q + 1);
}
template <int N>
constexpr int output_smem_floats() {
  return 4 * kChunk * (N + 1)                          // r, k, v, log w / cum
         + kChunk * (kChunk + 1)                       // A
         + N * (N + 8)                                 // S at the chunk's start
         + (kChunk - kSub) * (N + 1)                   // r e^{cum_exc - cum_ref(q-1)}
         + kPairs * N                                  // e^{cum_ref(q-1) - cum_ref(p)}
         + N;                                          // u
}

struct Geometry {
  int T, H, nch;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
}

// One chunk of (B, T, H, N) inputs into (kChunk, N + 1) f32 tiles, four
// channels a load and every load of a thread issued before the first store;
// log2(max(w, 1e-30)) for w.  Rows past T are masked to 0.  A null r_s skips r.
template <typename T, int N>
__device__ void load_chunk(const T* r, const T* k, const T* v, const float* w, long long base,
                           long long row, int len, float* r_s, float* k_s, float* v_s,
                           float* c_s) {
  constexpr int P = N + 1;
  constexpr int IT = kChunk * N / 4 / kThreads;
  static_assert(IT * 4 * kThreads == kChunk * N, "whole groups of four channels a thread");
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 rr[IT], kk[IT], vv[IT], ww[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int t = idx / (N / 4), n = (idx % (N / 4)) * 4;
    rr[it] = kk[it] = vv[it] = z;
    ww[it] = make_float4(1.f, 1.f, 1.f, 1.f);
    if (t < len) {
      const long long gi = base + t * row + n;
      if (r_s) rr[it] = load4(r + gi);
      kk[it] = load4(k + gi);
      vv[it] = load4(v + gi);
      ww[it] = load4(w + gi);
    }
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int t = idx / (N / 4), n = (idx % (N / 4)) * 4;
    if (r_s) store4(r_s + t * P + n, rr[it]);
    store4(k_s + t * P + n, kk[it]);
    store4(v_s + t * P + n, vv[it]);
    store4(c_s + t * P + n,
           make_float4(log2f(fmaxf(ww[it].x, 1e-30f)), log2f(fmaxf(ww[it].y, 1e-30f)),
                       log2f(fmaxf(ww[it].z, 1e-30f)), log2f(fmaxf(ww[it].w, 1e-30f))));
  }
}

// c_s: log2 w -> its inclusive cumulative sum within each 16-token
// sub-chunk, per channel, one thread a (channel, sub-chunk).  Sums that span
// sub-chunks are taken from the sub-chunk totals (`sub_sum`), so no
// difference of two long prefix sums, which would cancel in f32, is ever
// formed.  Ends with a barrier.
template <int N>
__device__ void local_cumsum(float* c_s) {
  constexpr int P = N + 1;
  static_assert(N * (kChunk / kSub) <= kThreads, "one thread a (channel, sub-chunk)");
  const int n = threadIdx.x % N, t0 = kSub * (threadIdx.x / N);
  if (threadIdx.x < N * (kChunk / kSub)) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {   // a fixed trip count: see the note on loops above
      acc += c_s[(t0 + j) * P + n];
      c_s[(t0 + j) * P + n] = acc;
    }
  }
  __syncthreads();
}

// The log2-decay of sub-chunks lo..hi-1 of channel n (0 when lo >= hi).
template <int N>
__device__ __forceinline__ float sub_sum(const float* c_s, int lo, int hi, int n) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kChunk / kSub; ++s)
    if (s >= lo && s < hi) acc += c_s[(kSub * s + kSub - 1) * (N + 1) + n];
  return acc;
}

// 1) dS = (k e^{total - cum})^T @ v and e^{total} of one (b, h, chunk).
//    Log-decays are kept in base 2, so every exponential is an exp2.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
rwkv6_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, float* __restrict__ ds,
                   float* __restrict__ decay, Geometry geo) {
  constexpr int P = N + 1;
  constexpr int R = N / 16;
  extern __shared__ float smem_state[];
  float* k_s = smem_state;
  float* v_s = k_s + kChunk * P;
  float* c_s = v_s + kChunk * P;

  const int c = blockIdx.x % geo.nch;
  const int bh = blockIdx.x / geo.nch;
  const int h = bh % geo.H, b = bh / geo.H;
  const int t0 = c * kChunk;
  const int len = min(kChunk, geo.T - t0);
  const long long row = (long long)geo.H * N;
  const long long base = ((long long)b * geo.T + t0) * row + (long long)h * N;

  load_chunk<T, N>(nullptr, k, v, w, base, row, len, nullptr, k_s, v_s, c_s);
  __syncthreads();
  local_cumsum<N>(c_s);

  // k e^{total - cum}: the rest of the token's sub-chunk, then the later ones
  constexpr int NS = kChunk / kSub;
  for (int idx = threadIdx.x; idx < kChunk * N; idx += kThreads) {
    const int t = idx / N, n = idx % N, q = t / kSub;
    const float rest = c_s[(kSub * q + kSub - 1) * P + n] - c_s[t * P + n];
    k_s[t * P + n] *= ex2(rest + sub_sum<N>(c_s, q + 1, NS, n));
  }
  __syncthreads();

  // SIMT FMAs in both instantiations (on the tensor cores in TF32 this
  // pass measured slower: its transposed k reads conflict in the banks)
  float* out = ds + (long long)blockIdx.x * N * N;
  {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int bb = 0; bb < R; ++bb) acc[a][bb] = 0.f;
    for (int i = 0; i < kChunk; ++i) {   // rows past T are zero
      float kk[R], vv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) kk[a] = k_s[i * P + ty + 16 * a];
#pragma unroll
      for (int bb = 0; bb < R; ++bb) vv[bb] = v_s[i * P + tx + 16 * bb];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int bb = 0; bb < R; ++bb) acc[a][bb] = fmaf(kk[a], vv[bb], acc[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int bb = 0; bb < R; ++bb) out[(ty + 16 * a) * N + tx + 16 * bb] = acc[a][bb];
  }
  for (int n = threadIdx.x; n < N; n += kThreads)
    decay[(long long)blockIdx.x * N + n] = ex2(sub_sum<N>(c_s, 0, NS, n));
}

// 2) The carry over the chunks, one thread per (b, h, n, j): each chunk's dS
//    becomes the state at that chunk's start, and S_T is written.
template <int N>
__global__ void __launch_bounds__(kCarryThreads)
rwkv6_carry_kernel(float* __restrict__ ds, const float* __restrict__ decay,
                   const float* __restrict__ s0, float* __restrict__ sT, int BH, int nch) {
  const long long idx = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (idx >= (long long)BH * N * N) return;
  const long long bh = idx / (N * N);
  const int e = (int)(idx % (N * N)), n = e / N;
  float s = s0[idx];
  float* d_bh = ds + bh * nch * N * N + e;
  const float* w_bh = decay + bh * nch * N + n;
  for (int c0 = 0; c0 < nch; c0 += kCarryBatch) {
    float inc[kCarryBatch], dec[kCarryBatch];
#pragma unroll
    for (int i = 0; i < kCarryBatch; ++i) {
      inc[i] = 0.f;
      dec[i] = 1.f;
      if (c0 + i < nch) {
        inc[i] = d_bh[(long long)(c0 + i) * N * N];
        dec[i] = w_bh[(long long)(c0 + i) * N];
      }
    }
#pragma unroll
    for (int i = 0; i < kCarryBatch; ++i) {
      if (c0 + i < nch) {
        d_bh[(long long)(c0 + i) * N * N] = s;
        s = fmaf(dec[i], s, inc[i]);
      }
    }
  }
  sT[idx] = s;
}

// 3) y of one (b, h, chunk) from A and the state at the chunk's start.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s_start,
                    T* __restrict__ y, Geometry geo) {
  constexpr int P = N + 1;
  constexpr int PA = kChunk + 1;
  constexpr int PS = N + 8;     // row stride of S: the tensor-core reads of a k step hit distinct banks
  constexpr int R = N / 16;
  constexpr int NS = kChunk / kSub;
  constexpr int TRI = kSub * (kSub + 1) / 2;   // entries of a diagonal block on or below it
  extern __shared__ float smem_out[];
  float* r_s = smem_out;                    // r, then r e^{cum_exc}
  float* k_s = r_s + kChunk * P;            // k, then k e^{cum_ref(p) - cum} in sub-chunk p
  float* v_s = k_s + kChunk * P;
  float* c_s = v_s + kChunk * P;            // log2 w, then its cumulative sum
  float* a_s = c_s + kChunk * P;            // A, entries i <= t
  float* s_s = a_s + kChunk * PA;           // (N, N) state at the chunk's start
  float* f_s = s_s + N * PS;                // rows t >= 16: r e^{cum_exc - cum_ref(q-1)}
  float* d_s = f_s + (kChunk - kSub) * P;   // (pair, N): e^{cum_ref(q-1) - cum_ref(p)}
  float* u_s = d_s + kPairs * N;

  const int c = blockIdx.x % geo.nch;
  const int bh = blockIdx.x / geo.nch;
  const int h = bh % geo.H, b = bh / geo.H;
  const int t0 = c * kChunk;
  const int len = min(kChunk, geo.T - t0);
  const long long row = (long long)geo.H * N;
  const long long base = ((long long)b * geo.T + t0) * row + (long long)h * N;
  const int tid = threadIdx.x;

  load_chunk<T, N>(r, k, v, w, base, row, len, r_s, k_s, v_s, c_s);
  const float* s_g = s_start + (long long)blockIdx.x * N * N;
#pragma unroll
  for (int it = 0; it < N * N / 4 / kThreads; ++it) {
    const int idx = 4 * (tid + it * kThreads);
    *reinterpret_cast<float4*>(s_s + idx / N * PS + idx % N) = load4(s_g + idx);
  }
  for (int n = tid; n < N; n += kThreads) u_s[n] = u[h * N + n];
  __syncthreads();
  local_cumsum<N>(c_s);

  // the diagonal blocks: one exponential per term below the diagonal, u on
  // it.  Entry rr of a block's lower triangle is (ti, ii); a thread takes
  // up to PER entries in one loop over n, so their exponentials and loads
  // overlap.  The loop has no branch: a thread past the last entry repeats
  // it and does not store, and the exponential is taken on the diagonal too
  // and replaced by u (a branch per term serialised the loop).
  {
    constexpr int ND = NS * TRI, PER = (ND + kThreads - 1) / kThreads;
    const float* rr_[PER];
    const float* kr_[PER];
    const float* ct_[PER];
    const float* ci_[PER];
    int tr[PER], ir[PER];
    bool below[PER];
    float acc[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = min(tid + j * kThreads, ND - 1);
      const int p = e / TRI, rr = e % TRI;
      int ti = (int)((sqrtf(8.f * rr + 1.f) - 1.f) * 0.5f);
      ti -= ti * (ti + 1) / 2 > rr;
      ti += (ti + 1) * (ti + 2) / 2 <= rr;
      const int ii = rr - ti * (ti + 1) / 2;
      tr[j] = kSub * p + ti;
      ir[j] = kSub * p + ii;
      below[j] = ii < ti;
      rr_[j] = r_s + tr[j] * P;
      kr_[j] = k_s + ir[j] * P;
      ct_[j] = c_s + max(tr[j] - 1, 0) * P;
      ci_[j] = c_s + ir[j] * P;
      acc[j] = 0.f;
    }
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      const float un = u_s[n];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float ex = ex2(fminf(ct_[j][n] - ci_[j][n], 0.f));
        acc[j] = fmaf(rr_[j][n] * kr_[j][n], below[j] ? ex : un, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (tid + j * kThreads >= ND) break;
      a_s[tr[j] * PA + ir[j]] = acc[j];
      a_s[ir[j] * PA + tr[j]] = below[j] ? 0.f : acc[j];   // 0 above the diagonal
    }
  }
  // the decay between the last tokens of sub-chunks p and q - 1: that of
  // the sub-chunks between them
#pragma unroll
  for (int j = 0; j < kPairs; ++j)
    for (int n = tid; n < N; n += kThreads)
      d_s[j * N + n] = ex2(sub_sum<N>(c_s, pair_p(j) + 1, pair_q(j), n));
  __syncthreads();             // the diagonal blocks are done with the raw r and k

  // the factors, each <= 1: k of sub-chunk p against its last token, r of
  // sub-chunk q >= 1 against the last token of sub-chunk q - 1, and
  // r e^{cum_exc} for the state's share of y
  for (int idx = tid; idx < kChunk * N; idx += kThreads) {
    const int t = idx / N, n = idx % N, q = t / kSub;
    const float ce = t % kSub ? c_s[(t - 1) * P + n] : 0.f;   // within the sub-chunk
    const float rv = r_s[t * P + n];
    if (q < NS - 1) k_s[t * P + n] *= ex2(c_s[(kSub * q + kSub - 1) * P + n] - c_s[t * P + n]);
    if (q > 0) f_s[(t - kSub) * P + n] = rv * ex2(ce);
    r_s[t * P + n] = rv * ex2(sub_sum<N>(c_s, 0, q, n) + ce);
  }
  __syncthreads();

  // the blocks below the diagonal, (q, p) with p < q:
  // A[t, i] = sum_n f[t, n] e^{cum_ref(q-1) - cum_ref(p)}[n] kf[i, n]
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16: on the tensor cores in TF32, warp w < 2 kPairs takes 8 columns of
    // block w / 2
    const int warp = tid / 32, lane = tid % 32;
    if (warp < 2 * kPairs) {
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        if (warp / 2 != j) continue;
        const int q = pair_q(j), p = pair_p(j), n0 = 8 * (warp % 2);
        float c[1][4] = {{0.f, 0.f, 0.f, 0.f}};
        warp_mma<N / 8, 1, true>(c, f_s + kSub * (q - 1) * P, P, k_s + kSub * p * P, P,
                                        n0, N / 8, lane, d_s + j * N);
        const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a_s[(kSub * q + g + 8 * (e >> 1)) * PA + kSub * p + n0 + t2 + (e & 1)] = c[0][e];
      }
    }
  } else {
    // f32: SIMT FMAs; thread (ti, ii) takes entry (16q + ti, 16p + ii) of
    // every such block in one loop over n
    const int ti = tid / kSub, ii = tid % kSub;
    float acc[kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float fr[NS - 1], kr[NS - 1];
#pragma unroll
      for (int j = 0; j < NS - 1; ++j) {
        fr[j] = f_s[(kSub * j + ti) * P + n];
        kr[j] = k_s[(kSub * j + ii) * P + n];
      }
#pragma unroll
      for (int j = 0; j < kPairs; ++j)
        acc[j] = fmaf(fr[pair_q(j) - 1] * d_s[j * N + n], kr[pair_p(j)], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kPairs; ++j)
      a_s[(kSub * pair_q(j) + ti) * PA + kSub * pair_p(j) + ii] = acc[j];
  }
  __syncthreads();

  // y = A @ v + (r e^{cum_exc}) @ S
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16: on the tensor cores in TF32.  Warp w owns 16-row tile w % NS and
    // NT 8-column tiles; A @ v stops at the tile's diagonal.
    constexpr int WPR = kThreads / 32 / NS, NT = N / 8 / WPR;
    const int warp = tid / 32, lane = tid % 32, rt = warp % NS, n0 = (warp / NS) * NT * 8;
    float c[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
    warp_mma<N / 8, NT>(c, r_s + kSub * rt * P, P, s_s, PS, n0, N / 8, lane);
    warp_mma<kChunk / 8, NT>(c, a_s + kSub * rt * PA, PA, v_s, P, n0, 2 * (rt + 1), lane);
    const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = kSub * rt + g + 8 * (e >> 1), j = n0 + 8 * nt + t2 + (e & 1);
        if (t < len) store_as(y + base + t * row + j, c[nt][e]);
      }
  } else {
    // f32: SIMT FMAs in full f32; thread owns rows ty + 16a, columns tx + 16b
    const int tx = tid % 16, ty = tid / 16;
    float acc[NS][R];
#pragma unroll
    for (int a = 0; a < NS; ++a)
#pragma unroll
      for (int bb = 0; bb < R; ++bb) acc[a][bb] = 0.f;
    for (int n = 0; n < N; ++n) {
      float sv[R];
#pragma unroll
      for (int bb = 0; bb < R; ++bb) sv[bb] = s_s[n * PS + tx + 16 * bb];
#pragma unroll
      for (int a = 0; a < NS; ++a) {
        const float rv = r_s[(ty + 16 * a) * P + n];
#pragma unroll
        for (int bb = 0; bb < R; ++bb) acc[a][bb] = fmaf(rv, sv[bb], acc[a][bb]);
      }
    }
    for (int i = 0; i < kChunk; ++i) {
      float vv[R];
#pragma unroll
      for (int bb = 0; bb < R; ++bb) vv[bb] = v_s[i * P + tx + 16 * bb];
#pragma unroll
      for (int a = 0; a < NS; ++a) {
        if (i >= kSub * (a + 1)) continue;   // A is 0 past the diagonal
        const float av = a_s[(ty + 16 * a) * PA + i];
#pragma unroll
        for (int bb = 0; bb < R; ++bb) acc[a][bb] = fmaf(av, vv[bb], acc[a][bb]);
      }
    }
#pragma unroll
    for (int a = 0; a < NS; ++a) {
      const int t = ty + 16 * a;
      if (t >= len) continue;
#pragma unroll
      for (int bb = 0; bb < R; ++bb) store_as(y + base + t * row + tx + 16 * bb, acc[a][bb]);
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* sT, void* ds, void* decay,
                   int B, int T_len, int H, cudaStream_t st) {
  const Geometry geo{T_len, H, (T_len + kChunk - 1) / kChunk};
  const long long blocks = (long long)B * H * geo.nch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int smem_state = state_smem_floats<N>() * (int)sizeof(float);
  constexpr int smem_out = output_smem_floats<N>() * (int)sizeof(float);
  static std::atomic<uint64_t> set_state{0}, set_out{0};
  cudaError_t e = set_smem_once(rwkv6_state_kernel<T, N>, smem_state, set_state);
  if (e != cudaSuccess) return e;
  e = set_smem_once(rwkv6_output_kernel<T, N>, smem_out, set_out);
  if (e != cudaSuccess) return e;

  rwkv6_state_kernel<T, N><<<(unsigned)blocks, kThreads, smem_state, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<float*>(ds), static_cast<float*>(decay), geo);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long elems = (long long)B * H * N * N;
  rwkv6_carry_kernel<N><<<(unsigned)((elems + kCarryThreads - 1) / kCarryThreads),
                          kCarryThreads, 0, st>>>(
      static_cast<float*>(ds), static_cast<const float*>(decay),
      static_cast<const float*>(s0), static_cast<float*>(sT), B * H, geo.nch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rwkv6_output_kernel<T, N><<<(unsigned)blocks, kThreads, smem_out, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(ds), static_cast<T*>(y), geo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* s0, void* y, void* sT, void* ds, void* decay,
                     int B, int T_len, int H, int N, cudaStream_t st) {
  switch (N) {
    case 32: return launch<T, 32>(r, k, v, w, u, s0, y, sT, ds, decay, B, T_len, H, st);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, y, sT, ds, decay, B, T_len, H, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, y: (B, T, H, N) float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// w: (B, T, H, N) float32; u: (H, N) float32; s0, sT: (B, H, N, N) float32.
// Scratch: ds (B, H, chunks, N, N) and decay (B, H, chunks, N) float32, with
// chunks = ceil(T / rwkv6_scan_chunk()).  All contiguous.  N in {32, 64},
// any T >= 1.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* sT, void* ds, void* decay, int B, int T_len,
                              int H, int N, int is_bf16, void* stream) {
  if (B < 1 || T_len < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, ds, decay, B, T_len, H, N, st);
  return dispatch<float>(r, k, v, w, u, s0, y, sT, ds, decay, B, T_len, H, N, st);
}

// Tokens a chunk of the kernels.
extern "C" int rwkv6_scan_chunk() { return kChunk; }

// Dynamic shared memory one block of the output kernel (the larger of the
// two chunk kernels) takes at head size N, in bytes; -1 if N is not built.
extern "C" int rwkv6_scan_smem_bytes(int N) {
  switch (N) {
    case 32: return output_smem_floats<32>() * (int)sizeof(float);
    case 64: return output_smem_floats<64>() * (int)sizeof(float);
    default: return -1;
  }
}

extern "C" const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
