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
// The scores are kept in base 2 (the scale times log2(e) in one multiply,
// then exp2), which gives the same weights.
//
// What bounds it on this card.  One query token streams the valid part of
// the cache once: at the serving shape (B=8, Hq=32, Hk=8, D=128, bf16, all
// 1024 slots valid) k and v are 33.5 MB, 10.0 us at 3.35 TB/s, against
// 4*D*Hq*sum(len) = 1.3e8 operations (0.14 us at the bf16 peak): it is bound
// by bytes.  So the design keeps the loads streaming and spends as few
// instructions as it can on each byte that lands.
//
// What the design does about it.
//  * Splits of several tiles.  The cache axis of each (b, kv head) is cut
//    into splits of `split_keys` slots, several 64-slot tiles each; the
//    wrapper sizes them from the SM count so that a full cache gives about
//    two blocks an SM, all resident at once.  A split that starts at or past
//    lengths[b] returns at once, so a short row costs only its used splits
//    and no slot past the length is ever read.  The grid is one dimension,
//    (b, kv head, head chunk, split), so any B and Hk run.
//  * A ring of cp.async stages.  K and V tiles land in shared memory in
//    their own dtype through 16-byte cp.async copies, three stages deep in
//    bf16 (two in f32, and in bf16 at D = 256, where a 64-slot K tile is
//    32 KB; f32 tiles hold 32 slots at D = 256), so the next tiles load
//    while this one is in use.  At D = 256 one block fills an SM's shared
//    memory (128 KB of ring).  A ragged last tile is zero-filled past its
//    end and masked.  bf16 rows are stored with their 16-byte chunks
//    XOR-swizzled by row, so the ldmatrix reads below hit eight distinct
//    bank groups.
//  * bfloat16: both products on the tensor cores (mma.sync m16n8k16).  The
//    g grouped queries are the 16 rows of the A operand (padded with zeros;
//    head chunks of 16 when g > 16), held in registers for the whole split.
//    Each warp owns 16 slots of every tile: S = Q K^T with K through
//    ldmatrix, the online softmax in registers (a row's 16 slots sit in one
//    quad of lanes), P rounded to bf16 (as the plain version rounds its
//    weights) and fed back from the S accumulators as the A operand of
//    O += P V, V through ldmatrix.trans.  Each K and V element is read from
//    shared memory once for all g heads.  mma.sync over the padded group
//    was chosen over SIMT dot products in a slice of D because the SIMT
//    form spends a shuffle reduction on every score and an f32 conversion
//    on every element, more instructions than the bytes leave time for;
//    the padding costs tensor-core time, of which this kernel uses little.
//  * float32: the same splits, ring and merges with SIMT FMAs in full f32
//    (no TF32): a lane owns D/32 elements of each head's query and
//    accumulator (heads in chunks of 8), and each score is reduced across
//    the warp's lanes.
//  * One launch.  The warps of a block merge their (m, l, acc) in shared
//    memory.  A row with one used split writes o at once; otherwise each
//    block writes an f32 partial, and the last block of its (b, kv head,
//    head chunk) to finish, counted by an int in scratch that it resets to
//    0 itself, merges the partials by their maxima (each head's weight a
//    split computed once, into shared memory) and writes o.  No host
//    sync and no allocation, so a CUDA graph can capture the launch.
//
// Float8 K/V.  A cache kept in float8_e4m3fn or float8_e5m2 under a bf16
// or f32 query (the served model's kv_dtype) is read as it is stored: the
// ring lands its tiles at one byte an element (half the bytes of bf16, a
// quarter of f32), and once a tile has landed the block widens it into one
// tile of q's dtype in shared memory, laid out as above, which the products
// then read.  Widening float8 to bf16 or f32 is exact, so the kernel
// computes what the plain version computes on the cache widened to q's
// dtype; q and P are not quantised.  The ring and the widened tile together
// take no more shared memory than the same ring in q's dtype, so the split
// plan stands as it is.
//
// Other float K/V.  bfloat16 or float16 K/V under an f32 query, and float32
// or float16 K/V under a bf16 query (a cache in another kv_dtype than the
// model's), take the same path: the tile lands at K/V's own width and is
// converted into one tile of q's dtype in shared memory.  Widening bf16 or
// f16 to f32 is exact; narrowing f32 or f16 to bf16 rounds to nearest even,
// as the plain version's cast (and jnp.astype) does.  A 2-byte tile under an
// f32 query is half an f32 one, so the ring keeps its two stages; under a
// bf16 query the converted tile is extra, so f16 K/V take two stages, and
// f32 K/V, whose landed tile is twice a bf16 one, two below D = 256 and one
// at D = 256 (160 KB and 192 KB a block with the converted tile): one block
// an SM, for which the wrapper plans its splits.

// Lengths are taken in [1, C]: a length above C counts as C, and a length
// below 1 gives a zero output (the reference has no meaning for it).  The
// kernel allocates nothing and launches on the stream it is given; the C
// entry point returns a cudaError_t and the Python wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;                 // cache slots a split is a multiple of
constexpr float kNegInf = -1e30f;
// K/V storage: q's dtype, or float8, bf16, f16 or f32 converted into q's
// dtype in shared memory
constexpr int kKvSame = 0, kKvE4M3 = 1, kKvE5M2 = 2, kKvBF16 = 3, kKvF16 = 4, kKvF32 = 5;

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kHeads = 16;     // rows of the mma A operand
};
template <> struct Cfg<float> {
  static constexpr int kHeads = 8;
};

// The ring at head size D: kRows cache slots a tile (warp w owns rows
// kRows/4 * w ..), kStages tiles of K and of V.  bf16 keeps 64-slot tiles
// (16 slots a warp, the mma's n); three stages below D=256, two at D=256,
// where a 64-slot tile of K is 32 KB.  f32 takes two stages, of 32-slot
// tiles at D=256, where a 64-slot tile of K would be 64 KB.
template <typename T, int D> struct Geo {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kRows = kF32 && D == 256 ? 32 : kBK;
  static constexpr int kStages = kF32 || D == 256 ? 2 : 3;
};

// bytes of a K/V element in device memory and in the ring
template <typename T, int KV>
__host__ __device__ constexpr int kv_bytes() {
  return KV == kKvSame ? (int)sizeof(T)
         : KV == kKvF32 ? 4
         : KV == kKvBF16 || KV == kKvF16 ? 2
                                          : 1;
}
// stages of the ring: float8 K/V keep q's dtype's; a converted tile of
// wider K/V costs a tile of q's dtype besides the ring, so two stages, and
// one for f32 K/V under bf16 q at D=256 (two would need 256 KB)
template <typename T, int KV, int D>
__host__ __device__ constexpr int stages() {
  return KV == kKvSame || kv_bytes<T, KV>() == 1 ? Geo<T, D>::kStages
         : kv_bytes<T, KV>() > (int)sizeof(T) && D == 256 ? 1
                                                           : 2;
}
// the ring; for converted K/V also the converted tile of K and of V in T
template <typename T, int KV, int D>
__host__ __device__ constexpr int ring_bytes() {
  return stages<T, KV, D>() * 2 * Geo<T, D>::kRows * D * kv_bytes<T, KV>()
         + (KV == kKvSame ? 0 : 2 * Geo<T, D>::kRows * D * (int)sizeof(T));
}
template <typename T, int D>
__host__ __device__ constexpr int merge_bytes() {
  // each warp's acc (kHeads, D), m and l
  return kWarps * Cfg<T>::kHeads * (D + 2) * (int)sizeof(float);
}
template <typename T, int KV, int D>
__host__ __device__ constexpr int smem_bytes_for() {
  return (ring_bytes<T, KV, D>() > merge_bytes<T, D>() ? ring_bytes<T, KV, D>()
                                                       : merge_bytes<T, D>())
         + 16;
}

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes on the current
// device, once: `done` holds a bit for each device it was set on.  Setting it
// once keeps the launch free of calls a CUDA graph capture would refuse.
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

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !valid (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Physical 16-byte chunk of logical chunk c in row r of a tile.  bf16 rows
// are swizzled so the 8 rows an ldmatrix reads at one logical chunk fall in
// 8 distinct 16-byte bank groups; f32 rows are read whole by a warp and are
// not swizzled.
template <typename T, int D>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (std::is_same<T, float>::value) return c;
  else if constexpr (D >= 64) return c ^ (r & 7);
  else return c ^ ((r >> 1) & 3);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}
// c += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two float8 values (the low byte first) to f32, exactly, through f16
template <int KV>
__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), KV == kKvE4M3 ? __NV_E4M3 : __NV_E5M2);
  return __half22float2(__half2(h));
}

// The 16 / kv_bytes K/V values of one landed 16-byte chunk as f32, exactly.
template <int KV>
__device__ __forceinline__ void chunk_to_float(const uint4 raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (KV == kKvE4M3 || KV == kKvE5M2) {
      const float2 lo = fp8x2_to_float2<KV>(w[i]);
      const float2 hi = fp8x2_to_float2<KV>(w[i] >> 16);
      f[4 * i] = lo.x;
      f[4 * i + 1] = lo.y;
      f[4 * i + 2] = hi.x;
      f[4 * i + 3] = hi.y;
    } else if constexpr (KV == kKvBF16) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else if constexpr (KV == kKvF16) {
      __half2_raw h;
      h.x = static_cast<unsigned short>(w[i] & 0xffffu);
      h.y = static_cast<unsigned short>(w[i] >> 16);
      const float2 x = __half22float2(__half2(h));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

// Convert a landed K/V tile (BK rows of D elements in KV's dtype, row-major,
// unswizzled) into BK rows of T laid out as WarpState::tile reads them
// (swizzled as a T tile lands).  Each thread takes one landed 16-byte chunk
// at a time, 16 / kv_bytes values: widened to f32 exactly, then stored as
// f32 or rounded to bf16 (to nearest even), one or more 16-byte chunks of T
// out, or half of one (f32 K/V under bf16 q).
template <typename T, int KV, int D, int BK>
__device__ __forceinline__ void widen_tile(const unsigned char* src, unsigned char* dst,
                                           int tid) {
  constexpr int KB = kv_bytes<T, KV>();
  constexpr int E = 16 / KB;                    // values a landed chunk
  constexpr int CPRL = D * KB / 16;             // landed chunks a row
  constexpr int OB = E * (int)sizeof(T);        // bytes of T a landed chunk gives
  constexpr int RB = D * (int)sizeof(T);        // bytes a converted row
  for (int idx = tid; idx < BK * CPRL; idx += kThreads) {
    const int r = idx / CPRL, c = idx % CPRL;
    float f[E];
    chunk_to_float<KV>(*reinterpret_cast<const uint4*>(src + r * D * KB + c * 16), f);
    unsigned char* row = dst + r * RB;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < OB / 16; ++j)
        *reinterpret_cast<float4*>(row + swz<T, D>(r, c * (OB / 16) + j) * 16) =
            make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
    } else if constexpr (OB >= 16) {
#pragma unroll
      for (int j = 0; j < OB / 16; ++j)
        *reinterpret_cast<uint4*>(row + swz<T, D>(r, c * (OB / 16) + j) * 16) =
            make_uint4(pack_bf16(f[8 * j], f[8 * j + 1]), pack_bf16(f[8 * j + 2], f[8 * j + 3]),
                       pack_bf16(f[8 * j + 4], f[8 * j + 5]),
                       pack_bf16(f[8 * j + 6], f[8 * j + 7]));
    } else {
      // 8 bytes: half of logical chunk c / 2
      *reinterpret_cast<uint2*>(row + swz<T, D>(r, c >> 1) * 16 + (c & 1) * 8) =
          make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part_acc;   // (rows, nsplit, kHeads, D), rows = B * Hk * HC
  float* part_ml;    // (rows, nsplit, kHeads, 2)
  int* counters;     // (rows,), zero between calls
  int C, Hq, Hk, HC, split_keys, nsplit;
  float scale_log2;  // 1/sqrt(D) * log2(e)
};

// One warp's running state over its slots of every tile of the split.
template <typename T, int D> struct WarpState;

// bfloat16: rows g and g + 8 of the mma tiles (g = lane / 4) are heads
// h0 + g and h0 + g + 8; a lane holds columns 2t, 2t + 1 of each 8-wide
// block (t = lane % 4).
template <int D>
struct WarpState<__nv_bfloat16, D> {
  static_assert(Geo<__nv_bfloat16, D>::kRows == 4 * 16, "a warp owns 16 slots of a tile");
  static constexpr int RB = D * 2;    // bytes a tile row
  uint32_t qa[D / 16][4];             // Q as the A operand, one per 16-wide k step
  float o[D / 8][4];                  // O accumulators, one per 8-wide block of D
  float m[2], l[2];                   // rows g and g + 8; l is this lane's share

  __device__ void init(const __nv_bfloat16* qh, int hb, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e & 1), col = kk * 16 + 2 * t + 8 * (e >> 1);
        qa[kk][e] = row < hb ? *reinterpret_cast<const uint32_t*>(qh + row * D + col) : 0u;
      }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // one tile: this warp's slots 16w..16w+15, cache slots k0 + those, valid
  // below k_end
  __device__ void tile(const char* ks, const char* vs, int k0, int k_end, int warp, int lane,
                       float scale_log2) {
    const int t = lane & 3, mi = lane >> 3;
    float s[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // matrices: (slots 0-7, d lo), (0-7, d hi), (8-15, d lo), (8-15, d hi)
      const int row = 16 * warp + 8 * (mi >> 1) + (lane & 7);
      const int ch = 2 * kk + (mi & 1);
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3, smem_u32(ks + row * RB + swz<__nv_bfloat16, D>(row, ch) * 16));
      mma_bf16(s[0], qa[kk], b0, b1);
      mma_bf16(s[1], qa[kk], b2, b3);
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + 16 * warp + 8 * nb + 2 * t + (e & 1);
        s[nb][e] = j < k_end ? s[nb][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float alpha[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
      const float m_new = fmaxf(m[rh], mx[rh]);
      alpha[rh] = exp2f(m[rh] - m_new);
      m[rh] = m_new;
      l[rh] *= alpha[rh];
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + 16 * warp + 8 * nb + 2 * t + (e & 1);
        const float p = j < k_end ? exp2f(s[nb][e] - m[e >> 1]) : 0.f;
        s[nb][e] = p;
        l[e >> 1] += p;
      }
    // the S accumulators of two 8-slot blocks are the A operand of one
    // 16-slot k step
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      // matrices: (slots 0-7, block nd), (8-15, nd), (0-7, nd+1), (8-15, nd+1)
      const int row = 16 * warp + 8 * (mi & 1) + (lane & 7);
      const int ch = nd + (mi >> 1);
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        smem_u32(vs + row * RB + swz<__nv_bfloat16, D>(row, ch) * 16));
      mma_bf16(o[nd], pa, b0, b1);
      mma_bf16(o[nd + 1], pa, b2, b3);
    }
  }

  // this warp's m, l and acc of heads < hb into shared memory
  __device__ void finish(float* mo, float* mm, float* ml, int hb, int warp, int lane) {
    constexpr int KH = Cfg<__nv_bfloat16>::kHeads;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
      l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
      const int row = g + 8 * rh;
      if (row >= hb) continue;
      float* dst = mo + (warp * KH + row) * D;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        dst[nd * 8 + 2 * t] = o[nd][2 * rh];
        dst[nd * 8 + 2 * t + 1] = o[nd][2 * rh + 1];
      }
      if (t == 0) {
        mm[warp * KH + row] = m[rh];
        ml[warp * KH + row] = l[rh];
      }
    }
  }
};

// float32: lane owns elements lane*VEC .. lane*VEC+VEC-1 of every head.
template <int D>
struct WarpState<float, D> {
  static constexpr int KH = Cfg<float>::kHeads;
  static constexpr int RW = Geo<float, D>::kRows / kWarps;   // slots a warp owns a tile
  static constexpr int VEC = D / 32;
  float qf[KH][VEC], acc[KH][VEC], m[KH], l[KH];
  int hb;

  __device__ void init(const float* qh, int hb_, int lane) {
    hb = hb_;
#pragma unroll
    for (int i = 0; i < KH; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qf[i][e] = i < hb ? qh[i * D + lane * VEC + e] : 0.f;
        acc[i][e] = 0.f;
      }
      m[i] = kNegInf;
      l[i] = 0.f;
    }
  }

  __device__ void tile(const char* ks, const char* vs, int k0, int k_end, int warp, int lane,
                       float scale_log2) {
    const float* kf = reinterpret_cast<const float*>(ks);
    const float* vf = reinterpret_cast<const float*>(vs);
    for (int jj = 0; jj < RW; ++jj) {
      const int r = RW * warp + jj;
      if (k0 + r >= k_end) break;                 // the same for the whole warp
      float kv[VEC], vv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kv[e] = kf[r * D + lane * VEC + e];
        vv[e] = vf[r * D + lane * VEC + e];
      }
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        if (i >= hb) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s = fmaf(qf[i][e], kv[e], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale_log2;
        const float m_new = fmaxf(m[i], s);
        const float alpha = exp2f(m[i] - m_new);
        const float p = exp2f(s - m_new);
        l[i] = l[i] * alpha + p;
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e] * alpha);
      }
    }
  }

  __device__ void finish(float* mo, float* mm, float* ml, int hb_, int warp, int lane) {
#pragma unroll
    for (int i = 0; i < KH; ++i) {
      if (i >= hb_) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e) mo[(warp * KH + i) * D + lane * VEC + e] = acc[i][e];
      if (lane == 0) {
        mm[warp * KH + i] = m[i];
        ml[warp * KH + i] = l[i];
      }
    }
  }
};

template <typename T, int KV, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Args a) {
  static_assert(D % 32 == 0, "head size");
  constexpr int KH = Cfg<T>::kHeads;
  constexpr int S = stages<T, KV, D>();
  constexpr int BK = Geo<T, D>::kRows;          // cache slots a tile
  constexpr int KB = kv_bytes<T, KV>();         // bytes a K/V element as stored
  constexpr int RBK = D * KB;                   // bytes a landed tile row
  constexpr int CPR = RBK / 16;                 // 16-byte chunks a landed row
  constexpr int TILEK = BK * RBK;               // bytes a landed K or V tile
  constexpr int TILE = BK * D * (int)sizeof(T); // bytes a K or V tile in T

  const int split = (int)(blockIdx.x % a.nsplit);
  const int rowid = (int)(blockIdx.x / a.nsplit);   // (b * Hk + hk) * HC + hc
  const int hc = rowid % a.HC;
  const int bh = rowid / a.HC;
  const int hk = bh % a.Hk, b = bh / a.Hk;
  const int g = a.Hq / a.Hk;
  const int h0 = hk * g + hc * KH;                  // first q head of this block
  const int hb = min(KH, g - hc * KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int len = min(a.lengths[b], a.C);
  T* out = static_cast<T*>(a.o) + ((long long)b * a.Hq + h0) * D;
  if (len < 1) {                                    // no valid slot: zeros
    if (split == 0)
      for (int e = tid; e < hb * D; e += kThreads) store_as(out + e, 0.f);
    return;
  }
  const int k_begin = split * a.split_keys;
  if (k_begin >= len) return;                       // the empty tail: never read
  const int k_end = min(k_begin + a.split_keys, len);
  const int used = (len + a.split_keys - 1) / a.split_keys;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const long long row = (long long)a.Hk * D;        // slot stride of k and v
  const long long kv_off = (long long)b * a.C * row + (long long)hk * D;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) + kv_off * KB;
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) + kv_off * KB;

  // a tile lands in its stored dtype: a T tile swizzled as tile() reads it,
  // a tile to convert row-major (widen_tile swizzles)
  auto load_tile = [&](int stage, int k0) {
    unsigned char* ks = smem + stage * 2 * TILEK;
    unsigned char* vs = ks + TILEK;
    for (int idx = tid; idx < BK * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const bool valid = k0 + r < k_end;
      const long long off = valid ? (long long)(k0 + r) * row * KB + c * 16 : 0;
      const int dst = r * RBK + (KV == kKvSame ? swz<T, D>(r, c) : c) * 16;
      cp_async16(ks + dst, kg + off, valid);
      cp_async16(vs + dst, vg + off, valid);
    }
  };

  WarpState<T, D> st;
  st.init(static_cast<const T*>(a.q) + ((long long)b * a.Hq + h0) * D, hb, lane);

  const int ntiles = (k_end - k_begin + BK - 1) / BK;
  if constexpr (S > 1) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < ntiles) load_tile(s, k_begin + s * BK);
      cp_async_commit();
    }
  }
  for (int it = 0; it < ntiles; ++it) {
    if constexpr (S > 1) {
      cp_async_wait<S - 2>();   // tile `it` has landed, for this thread's copies
      __syncthreads();          // for every thread's; and stage (it - 1) % S is free
      const int nt = it + S - 1;
      if (nt < ntiles) load_tile(nt % S, k_begin + nt * BK);
      cp_async_commit();
    } else {
      // one stage: every thread is past the last conversion (the barrier
      // after it), so the stage is free; load, wait, and the barrier below
      // also frees the converted tile the last products read
      load_tile(0, k_begin + it * BK);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const unsigned char* ks = smem + (it % S) * 2 * TILEK;
    if constexpr (KV != kKvSame) {
      // every warp is past the barrier above, done with the last converted tile
      unsigned char* wide = smem + S * 2 * TILEK;
      widen_tile<T, KV, D, BK>(ks, wide, tid);
      widen_tile<T, KV, D, BK>(ks + TILEK, wide + TILE, tid);
      __syncthreads();
      ks = wide;
    }
    st.tile(reinterpret_cast<const char*>(ks), reinterpret_cast<const char*>(ks + TILE),
            k_begin + it * BK, k_end, warp, lane, a.scale_log2);
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free: it becomes the merge area

  float* mo = reinterpret_cast<float*>(smem);       // (kWarps, KH, D)
  float* mm = mo + kWarps * KH * D;                 // (kWarps, KH)
  float* ml = mm + kWarps * KH;                     // (kWarps, KH)
  int* flag = reinterpret_cast<int*>(ml + kWarps * KH);
  st.finish(mo, mm, ml, hb, warp, lane);
  __syncthreads();

  // merge the warps; a row with one used split is done here
  const long long part = (long long)rowid * a.nsplit + split;
  for (int e = tid; e < hb * D; e += kThreads) {
    const int i = e / D, d = e % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mm[w * KH + i]);
    float L = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(mm[w * KH + i] - M);
      L = fmaf(f, ml[w * KH + i], L);
      acc = fmaf(f, mo[(w * KH + i) * D + d], acc);
    }
    if (used == 1) {
      store_as(out + e, acc / fmaxf(L, 1e-30f));
    } else {
      a.part_acc[part * KH * D + e] = acc;
      if (d == 0) {
        a.part_ml[(part * KH + i) * 2] = M;
        a.part_ml[(part * KH + i) * 2 + 1] = L;
      }
    }
  }
  if (used == 1) return;

  // the last block of this row to finish merges the used splits
  __threadfence();            // this thread's partial is visible device-wide
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(a.counters + rowid, 1);
    const int last = done == used - 1;
    if (last) a.counters[rowid] = 0;   // every other block has counted: reset
    *flag = last;
  }
  __syncthreads();
  const bool merges = *flag;
  __syncthreads();            // every thread has read the flag: the area is free
  if (!merges) return;
  __threadfence();
  // each head's weight for each used split, 2^(m_s - M), and its sum L,
  // once a head into shared memory (the warps' merge area is free again),
  // so each element below reads one partial a split
  const long long base = (long long)rowid * a.nsplit;
  float* fs = reinterpret_cast<float*>(smem);       // (used, KH)
  float* Ls = fs + used * KH;                       // (KH)
  for (int i = tid; i < hb; i += kThreads) {
    float M = kNegInf;
    for (int s = 0; s < used; ++s)
      M = fmaxf(M, __ldcg(a.part_ml + ((base + s) * KH + i) * 2));
    float L = 0.f;
    for (int s = 0; s < used; ++s) {
      const long long p = (base + s) * KH + i;
      const float f = exp2f(__ldcg(a.part_ml + p * 2) - M);
      fs[s * KH + i] = f;
      L = fmaf(f, __ldcg(a.part_ml + p * 2 + 1), L);
    }
    Ls[i] = L;
  }
  __syncthreads();
  // splits outermost: a thread's EPT loads of one split are independent, so
  // they are in flight together
  constexpr int EPT = (KH * D + kThreads - 1) / kThreads;   // elements a thread
  float acc[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc[j] = 0.f;
  for (int s = 0; s < used; ++s) {
    const float* part = a.part_acc + (base + s) * KH * D;
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int e = tid + j * kThreads;
      if (e < hb * D) acc[j] = fmaf(fs[s * KH + e / D], __ldcg(part + e), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * kThreads;
    if (e < hb * D) store_as(out + e, acc[j] / fmaxf(Ls[e / D], 1e-30f));
  }
}

template <typename T, int KV, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  constexpr int smem = smem_bytes_for<T, KV, D>();
  // the cross-split merge keeps a weight a (split, head) in shared memory
  if ((a.nsplit + 1) * Cfg<T>::kHeads * (int)sizeof(float) > smem) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = set_smem_once(flash_decode_kernel<T, KV, D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)B * a.Hk * a.HC * a.nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_decode_kernel<T, KV, D><<<(unsigned)blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int KV>
cudaError_t dispatch_d(const Args& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, KV, 32>(a, B, st);
    case 64: return launch<T, KV, 64>(a, B, st);
    case 128: return launch<T, KV, 128>(a, B, st);
    case 256: return launch<T, KV, 256>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, int D, int kv_kind, cudaStream_t st) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  switch (kv_kind) {
    case kKvSame: return dispatch_d<T, kKvSame>(a, B, D, st);
    case kKvE4M3: return dispatch_d<T, kKvE4M3>(a, B, D, st);
    case kKvE5M2: return dispatch_d<T, kKvE5M2>(a, B, D, st);
    case kKvF16: return dispatch_d<T, kKvF16>(a, B, D, st);
    case kKvBF16:
      if constexpr (kF32) return dispatch_d<T, kKvBF16>(a, B, D, st);
      else return cudaErrorInvalidValue;     // bf16 under bf16 q is kind 0
    case kKvF32:
      if constexpr (!kF32) return dispatch_d<T, kKvF32>(a, B, D, st);
      else return cudaErrorInvalidValue;     // f32 under f32 q is kind 0
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int KV>
int smem_of(int D) {
  switch (D) {
    case 32: return smem_bytes_for<T, KV, 32>();
    case 64: return smem_bytes_for<T, KV, 64>();
    case 128: return smem_bytes_for<T, KV, 128>();
    case 256: return smem_bytes_for<T, KV, 256>();
    default: return -1;
  }
}

template <typename T>
int smem_of_kind(int D, int kv_kind) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  switch (kv_kind) {
    case kKvSame: return smem_of<T, kKvSame>(D);
    case kKvE4M3: return smem_of<T, kKvE4M3>(D);
    case kKvE5M2: return smem_of<T, kKvE5M2>(D);
    case kKvF16: return smem_of<T, kKvF16>(D);
    case kKvBF16:
      if constexpr (kF32) return smem_of<T, kKvBF16>(D);
      else return -1;
    case kKvF32:
      if constexpr (!kF32) return smem_of<T, kKvF32>(D);
      else return -1;
    default: return -1;
  }
}

}  // namespace

// q, o: (B, Hq, D) float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); k, v:
// (B, C, Hk, D) in q's dtype (kv_kind = 0), float8_e4m3fn (1), float8_e5m2
// (2), bfloat16 under f32 q (3), float16 (4) or float32 under bf16 q (5);
// all contiguous and 16-byte aligned; lengths: (B,)
// int32.  Scratch, with HC = ceil(g / flash_decode_heads_per_block) and
// rows = B * Hk * HC: part_acc (rows, nsplit, heads_per_block, D) and
// part_ml (rows, nsplit, heads_per_block, 2) float32; counters (rows,) int32,
// all zero before the first call (each call leaves them zero).
// nsplit * split_keys >= C, split_keys a multiple of 64.  D in {32, 64, 128, 256},
// Hq % Hk == 0.  Calls that share scratch must be ordered on one stream.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* part_acc,
                                void* part_ml, void* counters, int B, int C, int Hq, int Hk,
                                int D, int split_keys, int nsplit, float scale, int is_bf16,
                                int kv_kind, void* stream) {
  if (B < 1 || C < 1 || Hq < 1 || Hk < 1 || Hq % Hk != 0 || split_keys < kBK ||
      split_keys % kBK != 0 || nsplit < 1 || (long long)nsplit * split_keys < C)
    return cudaErrorInvalidValue;
  const int kh = is_bf16 ? Cfg<__nv_bfloat16>::kHeads : Cfg<float>::kHeads;
  const int g = Hq / Hk;
  Args a{q, k, v, static_cast<const int*>(lengths), o, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), static_cast<int*>(counters), C, Hq, Hk,
         (g + kh - 1) / kh, split_keys, nsplit, scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(a, B, D, kv_kind, st);
  return dispatch<float>(a, B, D, kv_kind, st);
}

// Query heads one block holds (the head chunk): bf16 16, float32 8.
extern "C" int flash_decode_heads_per_block(int is_bf16) {
  return is_bf16 ? Cfg<__nv_bfloat16>::kHeads : Cfg<float>::kHeads;
}

// Dynamic shared memory one block takes at head size D for K/V of kv_kind,
// in bytes; -1 if D or kv_kind is not built.
extern "C" int flash_decode_smem_bytes(int D, int is_bf16, int kv_kind) {
  return is_bf16 ? smem_of_kind<__nv_bfloat16>(D, kv_kind) : smem_of_kind<float>(D, kv_kind);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
