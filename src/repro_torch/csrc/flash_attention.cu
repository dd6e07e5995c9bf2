// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body `_kernel`).  It
// computes the same function: causal (optionally windowed) or non-causal GQA
// attention, q (B,S,Hq,D) and k, v (B,S,Hk,D) -> o (B,S,Hq,D) in q's dtype,
// where the g = Hq/Hk query heads of a group read one K/V head:
//
//   s[i,j] = (q_i . k_j) / sqrt(D)   in f32, masked where
//            (causal: j > i; window w: j <= i - w; ragged tail: j >= S)
//   o_i    = sum_j softmax_j(s[i,:]) v_j
//
// with the online softmax of the TPU kernel: a running max m, running sum l
// and accumulator acc per query row, all f32, and o = acc / max(l, 1e-30).
// Every row has at least one key the masks let in, so a masked score of
// -inf here (-1e30 in the TPU kernel) gives the same weights.
//
// What bounds it on this card.  At the training shape (B=4, S=2048, Hq=16,
// D=64, bf16, causal) it reads q, k, v and writes o once, 6.7e7 bytes (20 us
// at 3.35 TB/s), and does 4*D operations per unmasked (i, j) pair, 3.4e10
// (35 us at the 989 TFLOP/s bf16 tensor-core peak): it is bound by the
// tensor cores.  The state per query row never leaves the chip, so the
// (S, S) score matrix is never written to device memory.
//
// Two kernels sit behind the one C entry point.
//
// bfloat16: `flash_attention_wgmma_kernel`, built for the tensor cores.
//  * Both products on the tensor cores.  S = Q K^T is a wgmma m64nBNk16
//    with Q and K both read from shared memory (K-major: rows are
//    D-contiguous), D/16 k-steps.  P is the S accumulator rounded to bf16 in
//    registers and fed back as wgmma's register A operand for O += P V
//    (the accumulator layout of two n8 column blocks is the A layout of one
//    k16 step), so P never touches shared memory; V is the shared-memory B
//    operand stored (keys, D), read with the transpose bit.  The softmax
//    scale and log2(e) are folded into one FMA before ex2.  A row's scores
//    live in one quad of lanes, so its max takes two shuffles.  BN = 128
//    keys a kv tile at D = 32 and 64, 64 at D = 128 and 256, where S, P and
//    O would not fit the registers with no spill.  At D = 256 (RecurrentGemma)
//    O += P V is one m64n256k16 a k step, its accumulator 128 registers a
//    thread.
//  * TMA loads.  One producer thread asks the Tensor Memory Accelerator for
//    each tile through tensor maps that view each (B,S,H,D) tensor as a 4-D
//    (D, H, S, B) array.  Tiles land in shared memory with the 128-byte
//    swizzle (64-byte at D=32) that the wgmma descriptors name, D=128 as
//    two 64-column panels.  K and V each have a ring of two stages with a
//    `full` mbarrier (TMA bytes) and an `empty` one (the consumer warps are
//    done).  The producer keeps K one tile ahead of V, and the consumer
//    issues S = Q K^T of a tile as soon as its K has landed and only then
//    waits for the previous tile's V, so neither product waits on the
//    other's load.  TMA fills rows past S with zeros; those keys are masked
//    and those query rows are not stored, so any S >= 1 runs.
//  * Warp specialisation.  A block is one consumer warpgroup (64 query
//    rows) and one producer warp, and two blocks share an SM (one at
//    D = 256: its Q tile and K and V rings take 161 KB), so one block's
//    first loads and last stores overlap the other's work.  In the
//    consumer, P V of the previous kv tile runs on the tensor cores while
//    the softmax of this tile runs beside it.
//  * One K/V tile for a whole GQA group, as the TPU kernel does.  A block
//    owns 64/hb token positions of hb = min(g, 64) heads of one kv head
//    (the heads of a group are adjacent in memory, so the Q tile is one
//    (tokens, heads, D) TMA box), and each K/V tile it loads serves all of
//    them.  Masks follow each row's token.  MHA is 64 tokens of one head.
//    When hb does not divide 64, the last rows are idle; when g > 64 a group
//    takes several head chunks.
//  * Work.  Only the kv tiles the causal mask and the window let in are
//    loaded; only tiles that cross the diagonal, the window edge or S are
//    masked, in a pass of their own so full tiles run straight-line code.
//    Blocks are numbered heaviest token tiles first, so the tail of the
//    grid is short.
//  What bounds it now (PERF.md): the tensor cores run at about 40% of their
//  peak at D = 128.  Blocks of two consumer warpgroups, and clusters of 2-8
//  blocks that multicast each K/V tile, read 1/2-1/8 of the K/V bytes from
//  L2 and ran slower at every shape measured on an H100; their own load
//  pipeline, timed with no math, was already slower than this one's, so
//  whether the L2 bytes bind is still open.

// float32: `flash_attention_simt_kernel`, kept in full f32 so the float32
// checks hold at 1e-4 (tensor cores in f32 would mean TF32).  Its tiles take
// 211 KB of shared memory at D = 256, so one block an SM there.  One block owns
// 64 query rows of one (b, q head) and loops over the kv tiles the masks let
// in, heaviest tiles first, with f32 FMAs from shared memory for both
// products (4x4 score and 4x(D/16) output register tiles per thread).
//
// The kernels allocate nothing and launch on the stream they are given; the
// C entry point returns a cudaError_t and the Python wrapper raises on it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes on the current
// device, once: `done` holds a bit for each device it was set on.
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

// ---------------------------------------------------------------- float32

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per kv tile
constexpr float kNegBig = -1e30f;

template <int D>
constexpr int simt_smem_bytes() {
  // q and k tiles (rows padded to D + 4), v tile, p tile (rows padded to 68)
  return (kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * (kBK + 4)) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int S,
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
  // one block a (query tile, b * Hq + h), all in gridDim.x so that any B * Hq
  // runs; the heaviest tiles (the last under a causal mask) launch first
  const int BH = gridDim.x / ((S + kBQ - 1) / kBQ);
  const int qt = (S + kBQ - 1) / kBQ - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);     // b * Hq + h
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * kBQ;

  const long long q_row = (long long)Hq * D;   // token stride of q and o
  const long long kv_row = (long long)Hk * D;  // token stride of k and v
  const long long q_off = (long long)b * S * q_row + (long long)h * D;
  const long long kv_off = (long long)b * S * kv_row + (long long)hk * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    q_s[r * PD + d] = q0 + r < S ? q[q_off + (q0 + r) * q_row + d] : 0.f;
  }

  // kv tiles that hold a key some row of this tile may see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegBig;
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
      k_s[r * PD + d] = in ? k[g] : 0.f;
      v_s[r * D + d] = in ? v[g] : 0.f;
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
      float mx = kNegBig;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int kp = k0 + tx + 16 * bb;
        ok[bb] = kp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[a][bb] = ok[bb] ? s[a][bb] * scale : kNegBig;
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
    for (int c = 0; c < NC; ++c) o[q_off + row * q_row + tx + 16 * c] = acc[a][c] / den;
  }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                        int S, int Hq, int Hk, float scale, int causal, int window,
                        cudaStream_t stream) {
  const int smem = simt_smem_bytes<D>();
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = set_smem_once(flash_attention_simt_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * B * Hq;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_simt_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq, Hk, scale, causal, window);
  return cudaGetLastError();
}

// ------------------------------------------------------------- bfloat16

constexpr int kRows = 64;         // query rows per block: one consumer warpgroup
constexpr int kConsumers = 128;   // its threads
constexpr int kTcThreads = 160;   // and one producer warp
constexpr int kStages = 2;        // depth of the K ring and of the V ring
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory tile geometry at head size D: rows of PW bytes (the swizzle
// span), PC bf16 columns each, NP panels side by side along D.
template <int D>
struct Tile {
  static constexpr int PW = D >= 64 ? 128 : 64;
  static constexpr int PC = PW / 2;
  static constexpr int NP = D / PC;
  static constexpr uint32_t kLayout = PW == 128 ? 1u : 2u;   // wgmma: 128B / 64B swizzle
};

// kv tile width at head size D: 64 at D=128 and D=256 keeps S, P and O in
// the consumers' registers (at D=256 the O accumulator alone is 128 a thread)
template <int D>
constexpr int tc_block_n() { return D >= 128 ? 64 : 128; }

// blocks an SM holds: two below D=256; at D=256 one, since a block's Q tile
// and two-stage K and V rings take 161 KB of shared memory and its O
// accumulator needs the registers that one block a SM leaves (up to 255 a
// thread)
template <int D>
constexpr int tc_blocks_per_sm() { return D == 256 ? 1 : 2; }

template <int D, int BN>
constexpr int tc_smem_bytes() {
  // 1024 bytes of alignment slack, the Q tile, the K and V rings, the mbarriers
  return 1024 + kRows * D * 2 + kStages * 2 * BN * D * 2 + 8 * (1 + 4 * kStages);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed; a barrier that
// never completes is a fault, so trap (a launch error) rather than hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (64 x N, f32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x N, bf16,
// shared, K-major); scale_d = 0 starts D at zero
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

// D (64 x N, f32) += A (64 x 16, bf16, registers) * B (16 x N, bf16, shared,
// N-major: the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One block: 64 query rows (T tokens x hb heads of kv head hk) against the
// kv tiles the masks let in.  Tensor maps view q, k, v as (D, H, S, B).
struct TcParams {
  __nv_bfloat16* o;
  int S, Hq, Hk, g;
  int hb, T, nhc;        // heads per block, tokens per block, head chunks per group
  int tiles;             // token tiles
  float scale_log2;      // softmax scale * log2(e)
  int causal, window;
};

// Warps 0-3 consume; warp 4 produces: one of its threads issues every TMA
// load.  K and V have rings of their own, and K runs one tile ahead of V, so
// S = Q K^T of a tile starts as soon as its K has landed, while P V of the
// previous tile still waits for V, and a K stage is refilled as soon as S is
// done.  In the consumer, P V of the previous kv tile runs on the tensor
// cores while the softmax of this tile runs beside it.
template <int D, int BN>
__global__ void __launch_bounds__(kTcThreads, tc_blocks_per_sm<D>())
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const TcParams p) {
  using L = Tile<D>;
  static_assert(D % 16 == 0 && BN % 16 == 0, "tile shape");
  constexpr int kQBytes = kRows * D * 2;
  constexpr int kKVBytes = BN * D * 2;        // one stage of K (or of V)
  constexpr int NS_ACC = BN / 2, NO_ACC = D / 2;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kQBytes;                    // stage s at sK + s * kKVBytes
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bar_q = sV + kStages * kKVBytes;   // then 8 bytes a barrier
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // block -> (token tile, b, kv head, head chunk); heaviest token tiles first
  const int per_tile = (int)(gridDim.x / p.tiles);
  const int tile = p.tiles - 1 - (int)blockIdx.x / per_tile;
  const int rest = (int)blockIdx.x % per_tile;
  const int hc = rest % p.nhc;
  const int hk = (rest / p.nhc) % p.Hk;
  const int b = rest / (p.nhc * p.Hk);
  const int tok0 = tile * p.T;
  const int tok_hi = min(tok0 + p.T, p.S) - 1;
  const int head0 = hk * p.g + hc * p.hb;
  const int rows = p.T * p.hb;

  const int kt_end = p.causal ? tok_hi / BN + 1 : (p.S + BN - 1) / BN;
  int kt_begin = 0;
  if (p.window > 0 && tok0 - p.window + 1 > 0) kt_begin = (tok0 - p.window + 1) / BN;
  const int n_tiles = kt_end - kt_begin;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers / 32);
      mbar_init(empty_v + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, rows * D * 2);
#pragma unroll
      for (int pn = 0; pn < L::NP; ++pn)
        tma_load_4d(sQ + pn * kRows * L::PW, &tm_q, bar_q, pn * L::PC, head0, tok0, b);
      auto load_k = [&](int it) {
        const int s = it % kStages, u = it / kStages;
        if (u > 0) mbar_wait(empty_k + 8 * s, (u - 1) & 1);
        mbar_expect_tx(full_k + 8 * s, kKVBytes);
#pragma unroll
        for (int pn = 0; pn < L::NP; ++pn)
          tma_load_4d(sK + s * kKVBytes + pn * BN * L::PW, &tm_k, full_k + 8 * s,
                      pn * L::PC, hk, (kt_begin + it) * BN, b);
      };
      load_k(0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, u = it / kStages;
        if (it + 1 < n_tiles) load_k(it + 1);   // K one tile ahead of V
        if (u > 0) mbar_wait(empty_v + 8 * s, (u - 1) & 1);
        mbar_expect_tx(full_v + 8 * s, kKVBytes);
#pragma unroll
        for (int pn = 0; pn < L::NP; ++pn)
          tma_load_4d(sV + s * kKVBytes + pn * BN * L::PW, &tm_v, full_v + 8 * s,
                      pn * L::PC, hk, (kt_begin + it) * BN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw, its warp wl.  A block has one warpgroup,
    // so cw is 0 and wtok0 is tok0, but indexing the Q tile, the tokens and
    // the rows by warpgroup lets ptxas schedule the consumer with more
    // registers (241 against 213 at D = 256), which ran 2-5% faster on an
    // H100 (PERF.md)
    const int cw = warp / 4, wl = warp % 4;
    const int wtok0 = (tile + cw) * p.T;             // this warpgroup's tokens
    const int wtok_hi = min(wtok0 + p.T, p.S) - 1;
    const uint32_t sQw = sQ + cw * kQBytes;
    // this thread's two rows (r0 and r0 + 8 of the warpgroup) and their tokens
    const int r0 = wl * 16 + (lane >> 2);
    int tq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) tq[h] = wtok0 + (r0 + 8 * h) / p.hb;
    const int cq = 2 * (lane & 3);   // this thread's first column in each n8 block

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o_acc[NO_ACC];
#pragma unroll
    for (int i = 0; i < NO_ACC; ++i) o_acc[i] = 0.f;
    uint32_t pa[BN / 16][4];   // P of the previous kv tile, bf16, register A layout

    auto issue_s = [&](float (&s_acc)[NS_ACC], int s) {   // S = Q K^T from K stage s
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk * 32 / L::PW, off = kk * 32 % L::PW;
        const uint64_t da = smem_desc(sQw + pn * kRows * L::PW + off, 16, 8 * L::PW,
                                      L::kLayout);
        const uint64_t db = smem_desc(sK + s * kKVBytes + pn * BN * L::PW + off, 16,
                                      8 * L::PW, L::kLayout);
        wgmma_ss<BN>(s_acc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int s) {   // O += P V from V stage s
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = smem_desc(sV + s * kKVBytes + kk * 16 * L::PW, BN * L::PW,
                                      8 * L::PW, L::kLayout);
        wgmma_rs<D>(o_acc, pa[kk], db);
      }
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {   // this warp is done with a stage
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // mask (only tiles that cross the diagonal, the window edge or S), the
    // row max on raw scores, p = 2^(s * scale * log2 e - m) in place, l;
    // returns each row's rescale factor for O
    auto softmax = [&](float (&s_acc)[NS_ACC], int k0, float (&alpha)[2]) {
      bool full = k0 + BN <= p.S;
      if (p.causal) full = full && k0 + BN - 1 <= wtok0;
      if (p.window > 0) full = full && k0 > wtok_hi - p.window;
      if (!full) {
#pragma unroll
        for (int j = 0; j < NS_ACC; ++j) {
          const int h = (j >> 1) & 1;
          const int col = k0 + (j >> 2) * 8 + cq + (j & 1);
          const bool ok = col < p.S && (!p.causal || col <= tq[h])
                          && (p.window <= 0 || col > tq[h] - p.window);
          s_acc[j] = ok ? s_acc[j] : -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS_ACC; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s_acc[j]);
      float m_use[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * p.scale_log2);
        m_use[h] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
        alpha[h] = ex2(m[h] - m_use[h]);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < NS_ACC; ++j) {
        const int h = (j >> 1) & 1;
        s_acc[j] = ex2(fmaf(s_acc[j], p.scale_log2, -m_use[h]));
        l[h] += s_acc[j];
      }
    };
    auto to_pa = [&](const float (&s_acc)[NS_ACC]) {   // P to bf16, register A layout
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s_acc[8 * kk + 0], s_acc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
    };

    mbar_wait(bar_q, 0);
    {   // the first kv tile: S, its softmax, P
      float s_acc[NS_ACC], alpha[2];
      mbar_wait(full_k, 0);
      __syncwarp();
      wgmma_fence();
      issue_s(s_acc, 0);
      wgmma_wait_all();
      fence_regs(s_acc);
      release(empty_k);
      softmax(s_acc, kt_begin * BN, alpha);
      to_pa(s_acc);
    }
    for (int it = 1; it < n_tiles; ++it) {
      // S of this tile and P V of the previous one on the tensor cores
      const int s = it % kStages, sp = (it - 1) % kStages;
      float s_acc[NS_ACC], alpha[2];
      mbar_wait(full_k + 8 * s, (it / kStages) & 1);
      __syncwarp();
      fence_regs(o_acc);
      wgmma_fence();
      issue_s(s_acc, s);   // as soon as K has landed, before waiting for V
      mbar_wait(full_v + 8 * sp, ((it - 1) / kStages) & 1);
      issue_pv(sp);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");   // S is done
      fence_regs(s_acc);
      release(empty_k + 8 * s);
      // this tile's softmax while P V runs
      softmax(s_acc, (kt_begin + it) * BN, alpha);
      wgmma_wait_all();
      fence_regs(o_acc);
      release(empty_v + 8 * sp);
#pragma unroll
      for (int j = 0; j < NO_ACC; ++j) o_acc[j] *= alpha[(j >> 1) & 1];
      to_pa(s_acc);
    }
    {   // the last tile's P V
      const int sp = (n_tiles - 1) % kStages;
      mbar_wait(full_v + 8 * sp, ((n_tiles - 1) / kStages) & 1);
      __syncwarp();
      fence_regs(o_acc);
      wgmma_fence();
      issue_pv(sp);
      wgmma_wait_all();
      fence_regs(o_acc);
    }

    // o = acc / l for the rows this block owns: token < S, head in the group
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int r = r0 + 8 * h;
      const int hh = r % p.hb;
      if (wtok0 >= p.S || r >= rows || tq[h] >= p.S || hc * p.hb + hh >= p.g) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* dst = p.o + (((long long)b * p.S + tq[h]) * p.Hq + head0 + hh) * D + cq;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        *reinterpret_cast<__nv_bfloat162*>(dst + nb * 8) = __floats2bfloat162_rn(
            o_acc[nb * 4 + 2 * h] * inv, o_acc[nb * 4 + 2 * h + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// a (D, H, S, B) view of a contiguous (B, S, H, D) bf16 tensor, boxes of
// (cols, heads, tokens, 1)
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int cols,
              int heads, int tokens, int swizzle_bytes) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)heads, (cuuint32_t)tokens, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int Hq, int Hk, float scale, int causal, int window,
                         cudaStream_t stream) {
  using L = Tile<D>;
  constexpr int BN = tc_block_n<D>();
  const int g = Hq / Hk;
  const int hb = g < kRows ? g : kRows;   // heads of one group a block
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
       | reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorMisalignedAddress;   // TMA reads from 16-byte aligned tensors
  TcParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.S = S; p.Hq = Hq; p.Hk = Hk; p.g = g;
  p.hb = hb; p.T = kRows / hb; p.nhc = (g + hb - 1) / hb;
  p.tiles = (S + p.T - 1) / p.T;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal; p.window = window;
  const long long blocks = (long long)p.tiles * B * Hk * p.nhc;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;

  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, S, Hq, D, L::PC, hb, p.T, L::PW)
      || !make_map(&tm_k, k, B, S, Hk, D, L::PC, 1, BN, L::PW)
      || !make_map(&tm_v, v, B, S, Hk, D, L::PC, 1, BN, L::PW))
    return cudaErrorInvalidValue;

  const int smem = tc_smem_bytes<D, BN>();
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = set_smem_once(flash_attention_wgmma_kernel<D, BN>, smem, smem_set);
  if (e != cudaSuccess) return e;
  flash_attention_wgmma_kernel<D, BN><<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

// Blocks of the bf16 kernel one SM of the current device holds at head size
// D, by CUDA's occupancy calculator; -1 on a CUDA error.
template <int D>
int wgmma_occupancy() {
  constexpr int BN = tc_block_n<D>();
  const int smem = tc_smem_bytes<D, BN>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_attention_wgmma_kernel<D, BN>,
                                                      kTcThreads, smem);
  return e == cudaSuccess ? n : -1;
}

}  // namespace

// q, o: (B, S, Hq, D); k, v: (B, S, Hk, D); all float32 (is_bf16 = 0) or all
// bfloat16 (is_bf16 = 1), contiguous.  D in {32, 64, 128, 256}, Hq % Hk == 0, any
// S >= 1.  window <= 0 means no window.  float32 runs the SIMT kernel, any
// B * Hq.  bfloat16 runs the wgmma kernel; q, k, v 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int Hq, int Hk, int D, float scale,
                                   int causal, int window, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || Hq < 1 || Hk < 1 || Hq % Hk != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (D) {
      case 32: return launch_wgmma<32>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
      case 64: return launch_wgmma<64>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
      case 128: return launch_wgmma<128>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
      case 256: return launch_wgmma<256>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 32: return launch_simt<32>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
    case 64: return launch_simt<64>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
    case 128: return launch_simt<128>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
    case 256: return launch_simt<256>(q, k, v, o, B, S, Hq, Hk, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

// Blocks of the bf16 kernel one SM of the current device holds at head size
// D; -1 if D is not built or on a CUDA error.
extern "C" int flash_attention_occupancy(int D) {
  switch (D) {
    case 32: return wgmma_occupancy<32>();
    case 64: return wgmma_occupancy<64>();
    case 128: return wgmma_occupancy<128>();
    case 256: return wgmma_occupancy<256>();
    default: return -1;
  }
}

// Dynamic shared memory one block takes at head size D, in bytes, for the
// bf16 (wgmma) or the f32 (SIMT) kernel; -1 if D is not built.  ptxas -v
// reports static shared memory only.
extern "C" int flash_attention_smem_bytes(int D, int is_bf16) {
  switch (D) {
    case 32: return is_bf16 ? tc_smem_bytes<32, tc_block_n<32>()>() : simt_smem_bytes<32>();
    case 64: return is_bf16 ? tc_smem_bytes<64, tc_block_n<64>()>() : simt_smem_bytes<64>();
    case 128: return is_bf16 ? tc_smem_bytes<128, tc_block_n<128>()>() : simt_smem_bytes<128>();
    case 256: return is_bf16 ? tc_smem_bytes<256, tc_block_n<256>()>() : simt_smem_bytes<256>();
    default: return -1;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
