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
//  * Splits.  The cache axis of each (b, kv head) is cut into splits of
//    `split_keys` slots, a multiple of 64; the wrapper sizes them from the
//    SM count so that a full cache gives about two blocks an SM (one where
//    a block takes more than half an SM's shared memory), all resident at
//    once.  A split past lengths[b] reads no slot, so a short row costs only
//    its used splits and no slot past the length is ever read.  The grid is
//    one dimension, (b, kv head, head chunk, split), so any B and Hk run.
//  * A ring of cp.async stages.  K and V tiles land in shared memory as
//    they are stored through 16-byte cp.async copies, so the next tiles
//    load while this one is in use.  A ragged last tile is zero-filled past
//    its end and masked.
//  * One launch, no host sync and no allocation, so a CUDA graph can
//    capture it.  A row with one used split writes o at once; otherwise its
//    splits' partials (acc, m, l) are merged by their maxima in the same
//    launch (how, below).
//
// Three kernels share that frame.
//
// The split-D kernel (flash_decode_split_kernel): a bfloat16 q at D = 256
// (RecurrentGemma: g = 16 query heads over one K/V head), over K/V in any
// kind.  A block takes one split; a full cache at B = 8 is 16 splits of 64
// slots a row, 128 blocks, each streaming 64 KB of K/V in bf16.  So a
// block's time is a chain (the length, its tiles landing at the rate one
// SM fetches, their products, the merge), and the design shortens it:
//  * Both products on the tensor cores (mma.sync m16n8k16, bf16 operands,
//    f32 accumulators; the 16 rows of the A operand are the g grouped
//    queries, padded with zeros; head chunks of 16 when g > 16).  The four
//    warps split the head dimension: warp w owns 64 of the 256 columns of
//    q, K, V and o, so a warp holds q's A operand (16 registers) and o (32)
//    for its columns only, not the 64 and 128 a warp owning all of D needs,
//    which spilled at 255 registers.  Each 32-slot tile: each warp
//    multiplies its columns of every slot and writes its partial S (the mma
//    accumulators, a float4 a lane); after a barrier warp w sums the four
//    partials of 8-slot block w in one order, masks and scales them and
//    writes its rows' maxima; after a barrier every warp reads the tile's
//    maxima (so m is the same in every warp), and warp w exponentiates its
//    block and writes P, rounded to bf16 (as the plain version rounds its
//    weights), as words of the A operand of O += P V; after a barrier each
//    warp multiplies P by its columns of V.  Each warp's l covers its own
//    blocks and is summed over the warps at the end.
//  * Tiles of 32 slots in two stages (one for f32 K/V, whose 32-slot tile
//    is 32 KB), so a 64-slot split's second tile lands while its first is
//    used, and a block takes at most 92 KB: two blocks an SM.
//  * One cluster a row.  The nsplit (at most 16) blocks of a (b, kv head,
//    head chunk) are launched as one thread block cluster.  When its loop
//    ends, a block pushes its partial acc, a float4 for each (warp, n-block,
//    lane), with remote stores into the shared memory of the block that
//    merges that float4, and its (m, l) by head into every block's; the
//    cluster meets once (its barrier releases the pushes); then each block
//    merges its slice of the float4s from its own shared memory, with each
//    head's weights 2^(m_s - M) computed once, and writes them to o.  A
//    last block reading every split's partial from global memory (the
//    slot-split kernel's merge) reads 16 partials of 16 KB through one SM
//    at the end of the call; the cluster's merge reads none from global
//    memory, spreads over the cluster's SMs and takes no scratch.
//    A 16-block cluster needs its blocks on one GPC at once, which two
//    blocks an SM allows.
//
// The slot-split kernel (flash_decode_kernel): a bfloat16 q at D <= 128.
// Each split's last block to finish, counted by an int in scratch that it
// resets to 0 itself, merges the partials from global memory (each head's
// (m, l) read eight splits at a time, its weight a split once into shared
// memory; the partials as float4s).  64-slot tiles, three stages (two for
// f32 K/V at D = 128, whose 64-slot tile is 32 KB).  Each warp owns 16 slots
// of every tile and all of D: S = Q K^T with Q in registers for the whole
// split, the online softmax in registers, P fed back from the S
// accumulators as the A operand of O += P V; the warps' (m, l, acc) merge in
// shared memory at the end.  K/V in q's dtype are read through ldmatrix
// (.trans for V), rows swizzled for it.
//
// The f32 kernel (flash_decode_f32_kernel): a float32 q, over K/V in f32,
// bf16, f16 or float8, in full f32 FMAs (no TF32), merged as the slot-split
// kernel merges.  A block holds 16 heads (8 at D = 256, so RecurrentGemma's
// 16 make two blocks a split and 256 blocks fill the card).  The online
// softmax is taken a tile at a time, not a slot at a time:
//  * scores: each thread takes one slot of the tile and its heads, reading
//    its K row against q, which the block holds once in shared memory (the
//    lanes of a warp read one q address, a broadcast), so no score waits on
//    a reduction across lanes; where the block has fewer heads than head
//    groups (MoE's g = 1), the idle groups take a share of the head's
//    16-byte chunks and the softmax sums the partial scores;
//  * softmax: warp w takes heads w, w + 4, ..: the tile's max in one
//    shuffle reduction a head, one rescale a head a tile, the exponentials
//    of its slots, P in place of S, l kept a lane's share until the end;
//  * P V: each thread owns columns of D and heads (all 16 where D >= 128),
//    P read four slots at a time as a broadcast float4;
//  * K/V are read as they landed and converted in registers as they are
//    read (exactly: float8, bf16 and f16 widen to f32), so no widened tile
//    and no barrier for one.  Tiles hold at most 16 KB of K (64 slots, 32
//    of f32 at D = 128, 16 at D = 256) and their rows are padded by 16
//    bytes, so the 8 rows a quarter warp reads at one column fall in 8 bank
//    groups; three stages where two blocks still fit an SM, else two.
//
// K/V in another dtype under a bf16 q (float8, f16, f32; and the split-D
// kernel's bf16), in the bf16 kernels: a lane reads the K and V elements its
// mma fragments need with ld.shared from the tile as it landed and
// converts them in registers into bf16 pairs (float8, bf16 and f16 widen
// exactly, f32 and f16 narrow to bf16 rounding to nearest even, as the
// plain version's cast and jnp.astype do), so no second tile in q's dtype is
// built and no barrier waits for one.  The mma's k index may follow any
// order of the columns as long as q's fragments follow it: a lane owns
// whole 16-byte chunks of a K row (chunks t, t+4, .. of the columns its
// warp multiplies) and of a V row (chunks g, g+8, ..), and o's columns
// follow V's.  Such a tile's 16-byte chunks are XOR-swizzled by row (bit 0
// of the row into bit 2 of the chunk, bits 1-2 in place) so that the reads
// of a quarter warp, two adjacent rows of K and four rows two apart of V,
// fall in distinct bank groups.

// Lengths are taken in [1, C]: a length above C counts as C, and a length
// below 1 gives a zero output (the reference has no meaning for it).  The
// kernel allocates nothing and launches on the stream it is given; the C
// entry point returns a cudaError_t and the Python wrapper raises on it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
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
// dtype in registers
constexpr int kKvSame = 0, kKvE4M3 = 1, kKvE5M2 = 2, kKvBF16 = 3, kKvF16 = 4, kKvF32 = 5;

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kHeads = 16;     // rows of the mma A operand
};
// The f32 kernel's heads a block: 16, which share each K/V tile it loads;
// 8 at D = 256, where 16 heads would leave a block the whole of a split's
// work and one block an SM at RecurrentGemma's shape (B = 8, Hk = 1).
__host__ __device__ constexpr int f32_heads(int D) { return D == 256 ? 8 : 16; }
// query heads a block of the variant for (D, q's dtype) holds
__host__ __device__ constexpr int heads_per_block(int D, bool bf16) {
  return bf16 ? Cfg<__nv_bfloat16>::kHeads : f32_heads(D);
}

// The slot-split kernel's ring at head size D: kRows cache slots a tile
// (warp w owns rows kRows/4 * w ..) of K and of V: 64-slot tiles, 16 slots a
// warp, the mma's n.
template <typename T, int D> struct Geo {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the f32 kernel has its own");
  static constexpr int kRows = kBK;
};

// bytes of a K/V element in device memory and in the ring
template <typename T, int KV>
__host__ __device__ constexpr int kv_bytes() {
  return KV == kKvSame ? (int)sizeof(T)
         : KV == kKvF32 ? 4
         : KV == kKvBF16 || KV == kKvF16 ? 2
                                          : 1;
}
// stages of the slot-split ring: three where they take at most 96 KB (two
// blocks an SM), else two (f32 K/V at D = 128)
template <typename T, int KV, int D>
__host__ __device__ constexpr int slot_stages() {
  return 3 * 2 * Geo<T, D>::kRows * D * kv_bytes<T, KV>() <= 98304 ? 3 : 2;
}
template <typename T, int KV, int D>
__host__ __device__ constexpr int ring_bytes() {
  return slot_stages<T, KV, D>() * 2 * Geo<T, D>::kRows * D * kv_bytes<T, KV>();
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

// The split-D kernel (D = 256): warp w of four owns columns [w*DS, (w+1)*DS).
template <int D> struct Split {
  static constexpr int NW = 4;                          // warps a block
  static constexpr int DS = D / NW;                     // columns a warp owns
  static constexpr int NT = 32 * NW;                    // threads a block
};
// The most splits a row of the split-D kernel takes: its blocks are one
// thread block cluster, 16 at most on an H100 (a non-portable size).
constexpr int kMaxCluster = 16;
// Its shared memory for K/V of kind KV under a bf16 q: a ring of 32-slot
// tiles of K and of V as stored (16 KB of K at 2 bytes an element, 8 KB in
// float8, 32 KB in f32), so a 64-slot split of the plan is two tiles, the
// second landing while the first is used: two stages where a block still
// fits twice on an SM, else one (f32); each warp's partial S of a tile (a
// float4 a lane for each 8-slot block), P as the A operand of O += P V (a
// uint4 a lane for each 16-slot k step), each warp's row maxima and sums; and
// what the blocks of the cluster push for this block's slice of the merge,
// their partials' float4s and their (m, l) by head, outside the ring so
// that a block may push while another works.  At most 92 KB, two blocks an
// SM, so that a 16-block cluster finds its SMs in one GPC.
template <int KV, int D> struct Ring {
  static constexpr int NW = Split<D>::NW, KH = Cfg<__nv_bfloat16>::kHeads;
  static constexpr int EB = kv_bytes<__nv_bfloat16, KV>();
  static constexpr int BK = 32;
  static constexpr int kTile = BK * D * EB;                        // bytes a K or V tile
  static constexpr int kSBuf = NW * (BK / 8) * 32 * 16             // the warps' partial S
                               + (BK / 16) * 32 * 16 + 2 * NW * KH * 4;  // P, row maxima, l
  static constexpr int kParts = KH * D / 4;                        // float4s of a partial
  static constexpr int kRecv = (kParts + kMaxCluster) * 16          // the slices pushed here
                               + kMaxCluster * KH * 8;              // and (m, l)
  static constexpr int kStages = 2 * 2 * kTile + kSBuf + kRecv <= 113 * 1024 ? 2 : 1;
  static constexpr int kRing = kStages * 2 * kTile;
  static constexpr int kSmem = kRing + kSBuf + kRecv;
  static_assert(kBK % BK == 0, "a split is whole tiles");
  static_assert(kSmem <= 113 * 1024, "two blocks an SM");
};

// Set `kernel`'s dynamic shared-memory limit to `smem` bytes on the current
// device (where `max_shared`, its carveout to the most shared memory, so two
// blocks of up to 113 KB share an SM; for the clustered split-D kernel also
// cluster sizes up to 16), once: `done` holds a bit for each device it was
// set on.  Setting it once keeps the launch free of calls a CUDA graph
// capture would refuse.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int smem, std::atomic<uint64_t>& done,
                          bool max_shared = false, bool clustered = false) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load() & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && max_shared)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && clustered)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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

// The 16 / kv_bytes K/V values of one landed 16-byte chunk (float8, bf16
// or f16) as f32, exactly.
template <int KV>
__device__ __forceinline__ void chunk_to_float(const uint4 raw, float* f) {
  static_assert(KV != kKvSame && KV != kKvF32, "widened kinds only");
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
    } else {
      __half2_raw h;
      h.x = static_cast<unsigned short>(w[i] & 0xffffu);
      h.y = static_cast<unsigned short>(w[i] >> 16);
      const float2 x = __half22float2(__half2(h));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// Physical 16-byte chunk of chunk c in row r of a tile of K/V read by
// converting loads (every tile of the split-D kernel; K/V in another dtype
// than a bf16 q in the slot-split one), CPR chunks a row: bit 0 of the row into bit 2 of the chunk, bits 1-2 in place, so
// that a quarter warp's reads (two adjacent rows of K, or four rows two
// apart of V) fall in distinct 16-byte bank groups.
template <int CPR>
__device__ __forceinline__ int swz_split(int r, int c) {
  constexpr int M = CPR >= 8 ? 7 : CPR - 1;
  return c ^ ((((r & 1) << 2) ^ (r & 6)) & M);
}

// The column, within the DS columns a warp multiplies (D/4 of them in the
// split-D kernel, all D in the slot-split one), of the i-th element that
// lane t of a quad owns for S = q K^T, in the order of the mma's k index (k step kk
// takes elements 4kk .. 4kk+3: k = 2t, 2t+1, 2t+8, 2t+9): whole 16-byte
// chunks t, t+4, .. of the slice where its DS/4 elements fill chunks, else
// one run of them.
template <int DS, int EB>
__device__ __forceinline__ int k_col(int t, int i) {
  constexpr int CE = 16 / EB, RUN = DS / 4;
  if constexpr (RUN >= CE) return (t + 4 * (i / CE)) * CE + i % CE;
  else return t * RUN + i;
}
// The column, within the DS columns a warp multiplies, of the j-th element that lane group g
// (lane / 4) owns for O += P V: column g of the mma's n-block j; chunks g,
// g+8, .. or one run of DS/8.
template <int DS, int EB>
__device__ __forceinline__ int v_col(int g, int j) {
  constexpr int CE = 16 / EB, RUN = DS / 8;
  if constexpr (RUN >= CE) return (g + 8 * (j / CE)) * CE + j % CE;
  else return g * RUN + j;
}

// NO bf16 pairs from raw words of K/V of kind KV (elements in order, the
// first in the low half): bf16 as it is, float8 widened exactly, f16 and
// f32 rounded to bf16 to nearest even.
template <int KV, int NO>
__device__ __forceinline__ void to_bf16(const uint32_t* raw, uint32_t* out) {
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    if constexpr (KV == kKvSame) {
      out[i] = raw[i];
    } else if constexpr (KV == kKvF32) {
      out[i] = pack_bf16(__uint_as_float(raw[2 * i]), __uint_as_float(raw[2 * i + 1]));
    } else if constexpr (KV == kKvF16) {
      __half2_raw h;
      h.x = static_cast<unsigned short>(raw[i] & 0xffffu);
      h.y = static_cast<unsigned short>(raw[i] >> 16);
      const float2 x = __half22float2(__half2(h));
      out[i] = pack_bf16(x.x, x.y);
    } else {
      const float2 x = fp8x2_to_float2<KV>(raw[i / 2] >> (16 * (i & 1)));
      out[i] = pack_bf16(x.x, x.y);
    }
  }
}

// The RUN elements that `idx` (t for K, g for V) owns in row r of a landed
// tile (the row's bytes at `rowp`), within the warp's slice from chunk c0
// on, as RUN/2 bf16 pairs: whole chunks idx, idx + STRIDE, .. or one run of
// RUN elements inside a chunk.
template <int KV, int CPR, int RUN, int STRIDE>
__device__ __forceinline__ void lane_run(const unsigned char* rowp, int r, int c0, int idx,
                                         uint32_t* out) {
  constexpr int EB = kv_bytes<__nv_bfloat16, KV>();
  constexpr int CE = 16 / EB;
  if constexpr (RUN >= CE) {
    constexpr int NC = RUN / CE;
    uint32_t raw[4 * NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          rowp + swz_split<CPR>(r, c0 + idx + STRIDE * i) * 16);
      raw[4 * i] = x.x;
      raw[4 * i + 1] = x.y;
      raw[4 * i + 2] = x.z;
      raw[4 * i + 3] = x.w;
    }
    to_bf16<KV, RUN / 2>(raw, out);
  } else {
    constexpr int NB = RUN * EB;                  // 2, 4 or 8 bytes
    const int byte = idx * NB;
    const unsigned char* p = rowp + swz_split<CPR>(r, c0 + byte / 16) * 16 + byte % 16;
    uint32_t raw[2] = {0u, 0u};
    if constexpr (NB == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      raw[0] = x.x;
      raw[1] = x.y;
    } else if constexpr (NB == 4) {
      raw[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      raw[0] = *reinterpret_cast<const unsigned short*>(p);
    }
    to_bf16<KV, RUN / 2>(raw, out);
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

// One warp's running state over its slots of every tile of the split, for
// K/V of kind KV.
template <typename T, int D, int KV> struct WarpState;

// bfloat16: rows g and g + 8 of the mma tiles (g = lane / 4) are heads
// h0 + g and h0 + g + 8.  K/V in q's dtype are read through ldmatrix, and a
// lane holds columns 2t, 2t + 1 of each 8-wide block (t = lane % 4); K/V in
// another dtype through converting loads (lane_run), the columns in k_col's
// order for S and v_col's for O.
template <int D, int KV>
struct WarpState<__nv_bfloat16, D, KV> {
  static_assert(Geo<__nv_bfloat16, D>::kRows == 4 * 16, "a warp owns 16 slots of a tile");
  static constexpr int EB = kv_bytes<__nv_bfloat16, KV>();
  static constexpr int RB = D * EB;   // bytes a tile row
  static constexpr int CPR = RB / 16; // 16-byte chunks a tile row
  uint32_t qa[D / 16][4];             // Q as the A operand, one per 16-wide k step
  float o[D / 8][4];                  // O accumulators, one per 8-wide block of D
  float m[2], l[2];                   // rows g and g + 8; l is this lane's share

  // the column of D that element e of n-block nd of O holds
  __device__ static int o_col(int nd, int e, int t) {
    if constexpr (KV == kKvSame) return nd * 8 + 2 * t + (e & 1);
    else return v_col<D, EB>(2 * t + (e & 1), nd);
  }

  __device__ void init(const __nv_bfloat16* qh, int hb, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e & 1);
        const int col = KV == kKvSame ? kk * 16 + 2 * t + 8 * (e >> 1)
                                      : k_col<D, EB>(t, 4 * kk + 2 * (e >> 1));
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
    if constexpr (KV == kKvSame) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // matrices: (slots 0-7, d lo), (0-7, d hi), (8-15, d lo), (8-15, d hi)
        const int row = 16 * warp + 8 * (mi >> 1) + (lane & 7);
        const int ch = 2 * kk + (mi & 1);
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b0, b1, b2, b3,
                    smem_u32(ks + row * RB + swz<__nv_bfloat16, D>(row, ch) * 16));
        mma_bf16(s[0], qa[kk], b0, b1);
        mma_bf16(s[1], qa[kk], b2, b3);
      }
    } else {
      // slot 16 warp + 8 nb + g of n-block nb: its elements in k_col's order
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int row = 16 * warp + 8 * nb + (lane >> 2);
        uint32_t kb[D / 8];
        lane_run<KV, CPR, D / 4, 4>(reinterpret_cast<const unsigned char*>(ks) + row * RB, row,
                                    0, t, kb);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) mma_bf16(s[nb], qa[kk], kb[2 * kk], kb[2 * kk + 1]);
      }
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
    if constexpr (KV == kKvSame) {
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
    } else {
      // B's pairs are rows (2t, 2t + 1) and (2t + 8, 2t + 9) of this warp's
      // slots at one column, v_col's
      uint32_t vw[4][D / 16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * warp + 2 * t + (q & 1) + 8 * (q >> 1);
        lane_run<KV, CPR, D / 8, 8>(reinterpret_cast<const unsigned char*>(vs) + row * RB, row,
                                    0, lane >> 2, vw[q]);
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const uint32_t sel = (nd & 1) ? 0x7632u : 0x5410u;   // the high or the low halves
        mma_bf16(o[nd], pa, __byte_perm(vw[0][nd >> 1], vw[1][nd >> 1], sel),
                 __byte_perm(vw[2][nd >> 1], vw[3][nd >> 1], sel));
      }
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
        dst[o_col(nd, 0, t)] = o[nd][2 * rh];
        dst[o_col(nd, 1, t)] = o[nd][2 * rh + 1];
      }
      if (t == 0) {
        mm[warp * KH + row] = m[rh];
        ml[warp * KH + row] = l[rh];
      }
    }
  }
};

// The cross-split merge of a row's used splits (more than one), whose
// partials (acc (KH, D) and (m, l) by head) each block wrote to the scratch:
// the last block of the row to finish merges them into o.  `smem` holds at
// least (used + 1) * KH floats and is free once every thread is past the
// first barrier here; `flag`, a shared int, is free on entry.
template <typename T, int KH, int D, int NT>
__device__ __forceinline__ void merge_splits(const Args& a, unsigned char* smem, int* flag,
                                             int rowid, int used, int hb, T* out, int tid) {
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
  // the splits' (m, l) of a head are read MS at a time, their loads in
  // flight together
  constexpr int MS = 8;
  for (int i = tid; i < hb; i += NT) {
    const float2* ml = reinterpret_cast<const float2*>(a.part_ml) + base * KH + i;
    float M = kNegInf;
    for (int s0 = 0; s0 < used; s0 += MS) {
      float x[MS];
#pragma unroll
      for (int u = 0; u < MS; ++u) x[u] = s0 + u < used ? __ldcg(ml + (s0 + u) * KH).x : kNegInf;
#pragma unroll
      for (int u = 0; u < MS; ++u) M = fmaxf(M, x[u]);
    }
    float L = 0.f;
    for (int s0 = 0; s0 < used; s0 += MS) {
      float2 x[MS];
#pragma unroll
      for (int u = 0; u < MS; ++u)
        x[u] = s0 + u < used ? __ldcg(ml + (s0 + u) * KH) : make_float2(kNegInf, 0.f);
#pragma unroll
      for (int u = 0; u < MS; ++u) {
        const float f = exp2f(x[u].x - M);
        if (s0 + u < used) fs[(s0 + u) * KH + i] = f;
        L = fmaf(f, x[u].y, L);
      }
    }
    Ls[i] = L;
  }
  __syncthreads();
  // splits outermost: a thread's EPT float4 loads of one split are
  // independent, so they are in flight together
  constexpr int EPT = (KH * D / 4 + NT - 1) / NT;   // float4s a thread
  float4 acc[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < used; ++s) {
    const float4* part = reinterpret_cast<const float4*>(a.part_acc + (base + s) * KH * D);
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int e = tid + j * NT;
      if (e < hb * D / 4) {
        const float f = fs[s * KH + 4 * e / D];
        const float4 x = __ldcg(part + e);
        acc[j].x = fmaf(f, x.x, acc[j].x);
        acc[j].y = fmaf(f, x.y, acc[j].y);
        acc[j].z = fmaf(f, x.z, acc[j].z);
        acc[j].w = fmaf(f, x.w, acc[j].w);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * NT;
    if (e < hb * D / 4) {
      const float L = fmaxf(Ls[4 * e / D], 1e-30f);
      store_as(out + 4 * e, acc[j].x / L);
      store_as(out + 4 * e + 1, acc[j].y / L);
      store_as(out + 4 * e + 2, acc[j].z / L);
      store_as(out + 4 * e + 3, acc[j].w / L);
    }
  }
}

template <typename T, int KV, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Args a) {
  static_assert(D % 32 == 0, "head size");
  constexpr int KH = Cfg<T>::kHeads;
  static_assert(std::is_same<T, __nv_bfloat16>::value && D <= 128,
                "an f32 q takes the f32 kernel, a bf16 q at D = 256 the split-D one");
  constexpr int S = slot_stages<T, KV, D>();
  constexpr int BK = Geo<T, D>::kRows;          // cache slots a tile
  constexpr int KB = kv_bytes<T, KV>();         // bytes a K/V element as stored
  constexpr int RBK = D * KB;                   // bytes a landed tile row
  constexpr int CPR = RBK / 16;                 // 16-byte chunks a landed row
  constexpr int TILEK = BK * RBK;               // bytes a landed K or V tile

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

  // a tile lands in its stored dtype, swizzled as tile() reads it (ldmatrix's
  // order for bf16, converting loads' for other K/V)
  auto load_tile = [&](int stage, int k0) {
    unsigned char* ks = smem + stage * 2 * TILEK;
    unsigned char* vs = ks + TILEK;
    for (int idx = tid; idx < BK * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const bool valid = k0 + r < k_end;
      const long long off = valid ? (long long)(k0 + r) * row * KB + c * 16 : 0;
      const int dst = r * RBK + (KV == kKvSame ? swz<T, D>(r, c) : swz_split<CPR>(r, c)) * 16;
      cp_async16(ks + dst, kg + off, valid);
      cp_async16(vs + dst, vg + off, valid);
    }
  };

  WarpState<T, D, KV> st;
  st.init(static_cast<const T*>(a.q) + ((long long)b * a.Hq + h0) * D, hb, lane);

  const int ntiles = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ntiles) load_tile(s, k_begin + s * BK);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<S - 2>();   // tile `it` has landed, for this thread's copies
    __syncthreads();          // for every thread's; and stage (it - 1) % S is free
    const int nt = it + S - 1;
    if (nt < ntiles) load_tile(nt % S, k_begin + nt * BK);
    cp_async_commit();
    const unsigned char* ks = smem + (it % S) * 2 * TILEK;
    st.tile(reinterpret_cast<const char*>(ks), reinterpret_cast<const char*>(ks + TILEK),
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
  merge_splits<T, KH, D, kThreads>(a, smem, flag, rowid, used, hb, out, tid);
}

// ---- the f32 kernel ----------------------------------------------------------

// The f32 kernel's geometry for K/V of kind KV at head size D.  Tiles of BK
// slots hold at most 16 KB of K (or V) as stored, 64 slots where that fits;
// each landed row is padded by 16 bytes, so the 8 rows that a quarter warp
// reads at one 16-byte column of a tile fall in 8 distinct bank groups; three
// stages where they and the block's q, S and P leave room for two blocks an
// SM, else two.  The scores give each thread one slot of the tile and HPT of
// the KH heads (head groups NG apart); P V gives each thread CPT columns
// (CT apart) of HPV heads (HG apart).
template <int KV, int D> struct F32Tile {
  static constexpr int KH = f32_heads(D);
  static constexpr int KB = kv_bytes<float, KV>();   // bytes an element as stored
  static constexpr int RB = D * KB;                  // bytes a landed row
  static constexpr int CPR = RB / 16;                // 16-byte chunks a row
  static constexpr int E = 16 / KB;                  // values a chunk
  static constexpr int RS = RB + 16;                 // row stride in the ring
  static constexpr int BK = 16384 / RB < kBK ? 16384 / RB : kBK;
  static constexpr int TILE = BK * RS;               // bytes a K or V tile
  static constexpr int SP = BK + 4;                  // row stride of S and P, floats
  // q (KH, D), S and P (KH, SP), the rescale, m and l by head, the merge flag
  static constexpr int kExtra = (KH * D + KH * SP + 3 * KH) * 4 + 16;
  static constexpr int kStages = 3 * 2 * TILE + kExtra <= 113 * 1024 ? 3 : 2;
  static constexpr int kSmem = kStages * 2 * TILE + kExtra;
  static constexpr int NG = kThreads / BK, HPT = KH / NG;
  static constexpr int CT = D < kThreads ? D : kThreads, HG = kThreads / CT;
  static constexpr int CPT = D / CT, HPV = KH / HG;
  static_assert(kBK % BK == 0 && BK % 4 == 0 && kThreads % BK == 0 && KH % NG == 0 &&
                    KH % HG == 0,
                "tile shape");
  static_assert(kSmem <= 113 * 1024, "two blocks an SM");
};

// the E values of a landed 16-byte chunk of K/V of kind KV as f32, exactly
template <int KV>
__device__ __forceinline__ void chunk_f32(const unsigned char* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (KV == kKvSame) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  } else {
    chunk_to_float<KV>(raw, f);
  }
}

// one landed K/V element of kind KV as f32, exactly
template <int KV>
__device__ __forceinline__ float elem_f32(const unsigned char* p) {
  if constexpr (KV == kKvSame) {
    return *reinterpret_cast<const float*>(p);
  } else if constexpr (KV == kKvBF16) {
    return __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
  } else if constexpr (KV == kKvF16) {
    return __half2float(__ushort_as_half(*reinterpret_cast<const unsigned short*>(p)));
  } else {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(*reinterpret_cast<const __nv_fp8_storage_t*>(p),
                                                 KV == kKvE4M3 ? __NV_E4M3 : __NV_E5M2);
    return __half2float(__half(h));
  }
}

// The f32 kernel: an f32 q over K/V in any kind, in full f32 FMAs (no TF32).
// One block a split of a (b, kv head, head chunk of 16 heads); the online
// softmax is taken a tile at a time: each thread scores one slot of the tile
// against its heads from q in shared memory, with no reduction across lanes;
// then warp w takes heads w, w + 4, .. : one max, one rescale and the
// exponentials of the tile's slots a head; then each thread adds P V for its
// columns and heads, P read four slots at a time.  K/V are converted as they
// are read from the tile as it landed, in registers.  Each split's last
// block merges the row's partials from global memory.
template <int KV, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_f32_kernel(const Args a) {
  using G = F32Tile<KV, D>;
  constexpr int KH = G::KH, BK = G::BK, S = G::kStages, KB = G::KB, RS = G::RS;
  constexpr int CPR = G::CPR, E = G::E, TILE = G::TILE, SP = G::SP;

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
  float* out = static_cast<float*>(a.o) + ((long long)b * a.Hq + h0) * D;
  if (len < 1) {                                    // no valid slot: zeros
    if (split == 0)
      for (int e = tid; e < hb * D; e += kThreads) out[e] = 0.f;
    return;
  }
  const int k_begin = split * a.split_keys;
  if (k_begin >= len) return;                       // the empty tail: never read
  const int k_end = min(k_begin + a.split_keys, len);
  const int used = (len + a.split_keys - 1) / a.split_keys;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;                   // S stages of (K tile, V tile)
  float* q_s = reinterpret_cast<float*>(ring + S * 2 * TILE);   // (KH, D)
  float* sp = q_s + KH * D;                         // (KH, SP): S, then P
  float* alpha_s = sp + KH * SP;                    // (KH)
  float* m_s = alpha_s + KH;                        // (KH)
  float* l_s = m_s + KH;                            // (KH)
  int* flag = reinterpret_cast<int*>(l_s + KH);

  const long long row = (long long)a.Hk * D * KB;   // bytes from a slot of k (v) to the next
  const long long kv_off = ((long long)b * a.C * a.Hk + hk) * D * KB;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) + kv_off;
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) + kv_off;
  auto load_tile = [&](int stage, int k0) {
    unsigned char* ks = ring + stage * 2 * TILE;
    unsigned char* vs = ks + TILE;
    for (int idx = tid; idx < BK * CPR; idx += kThreads) {
      const int r = idx / CPR, c = idx % CPR;
      const bool valid = k0 + r < k_end;
      const long long off = valid ? (long long)(k0 + r) * row + c * 16 : 0;
      cp_async16(ks + r * RS + c * 16, kg + off, valid);
      cp_async16(vs + r * RS + c * 16, vg + off, valid);
    }
  };

  const int ntiles = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ntiles) load_tile(s, k_begin + s * BK);
    cp_async_commit();
  }
  {   // q of this block's heads once, zeros past hb
    const float4* qg = reinterpret_cast<const float4*>(
        static_cast<const float*>(a.q) + ((long long)b * a.Hq + h0) * D);
    float4* qs4 = reinterpret_cast<float4*>(q_s);
    for (int e = tid; e < KH * D / 4; e += kThreads)
      qs4[e] = e < hb * D / 4 ? qg[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // scores: slot js, heads hs + NG i; where the block has fewer heads than
  // head groups, `parts` groups split each head's chunks (part p takes
  // chunks p, p + parts, ..) and the softmax sums their partial scores
  const int js = tid % BK, hs0 = tid / BK;
  const int parts = hb >= G::NG ? 1 : G::NG / hb;
  const int hs = parts == 1 ? hs0 : hs0 % hb, part = parts == 1 ? 0 : hs0 / hb;
  const int pc = tid % G::CT, ph0 = tid / G::CT;    // P V: columns pc + CT x, heads ph0 + HG i
  float m[KH / 4], lp[KH / 4];                      // softmax: heads warp + 4u; l a lane's share
#pragma unroll
  for (int u = 0; u < KH / 4; ++u) {
    m[u] = kNegInf;
    lp[u] = 0.f;
  }
  float acc[G::HPV][G::CPT];
#pragma unroll
  for (int i = 0; i < G::HPV; ++i)
#pragma unroll
    for (int x = 0; x < G::CPT; ++x) acc[i][x] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<S - 2>();   // tile `it` has landed, for this thread's copies
    __syncthreads();          // for every thread's; stage (it - 1) % S and P are free
    const int nt = it + S - 1;
    if (nt < ntiles) load_tile(nt % S, k_begin + nt * BK);
    cp_async_commit();
    const unsigned char* ks = ring + (it % S) * 2 * TILE;
    const unsigned char* vs = ks + TILE;
    const int k0 = k_begin + it * BK;

    if (part < parts) {   // 1) this thread's slot against its heads: S = q K^T
      float sc[G::HPT];
#pragma unroll
      for (int i = 0; i < G::HPT; ++i) sc[i] = 0.f;
      const unsigned char* krow = ks + js * RS;
      auto chunk = [&](int c) {
        float kf[E];
        chunk_f32<KV>(krow + c * 16, kf);
#pragma unroll
        for (int i = 0; i < G::HPT; ++i) {
          if (hs + G::NG * i >= hb) break;
          const float* qh = q_s + (hs + G::NG * i) * D + c * E;
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qh + e);
            sc[i] = fmaf(qv.x, kf[e], sc[i]);
            sc[i] = fmaf(qv.y, kf[e + 1], sc[i]);
            sc[i] = fmaf(qv.z, kf[e + 2], sc[i]);
            sc[i] = fmaf(qv.w, kf[e + 3], sc[i]);
          }
        }
      };
      if (parts == 1) {
#pragma unroll 4
        for (int c = 0; c < CPR; ++c) chunk(c);
      } else {
        for (int c = part; c < CPR; c += parts) chunk(c);
      }
      // a head's partial sums of part p in row p * hb + h, its S in row h
#pragma unroll
      for (int i = 0; i < G::HPT; ++i) {
        const int h = hs + G::NG * i;
        if (h >= hb) break;
        sp[(part * hb + h) * SP + js] = sc[i];
      }
    }
    __syncthreads();

    // 2) a head at a time: the tile's max, one rescale, P in place of S
    constexpr int NV = BK >= 32 ? BK / 32 : 1;      // slots a lane
#pragma unroll
    for (int u = 0; u < KH / 4; ++u) {
      const int h = warp + 4 * u;
      if (h >= hb) break;                           // the same for the whole warp
      float x[NV];
      float mx = kNegInf;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = lane + 32 * v;
        x[v] = kNegInf;
        if (j < BK) {
          float sj = sp[h * SP + j];
          for (int q = 1; q < parts; ++q) sj += sp[(q * hb + h) * SP + j];
          if (k0 + j < k_end) x[v] = sj * a.scale_log2;   // base 2; masked past the length
        }
        mx = fmaxf(mx, x[v]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[u], mx);
      const float alpha = exp2f(m[u] - m_new);
      m[u] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = lane + 32 * v;
        if (j < BK) {
          const float pj = k0 + j < k_end ? exp2f(x[v] - m_new) : 0.f;
          sp[h * SP + j] = pj;
          ps += pj;
        }
      }
      lp[u] = fmaf(lp[u], alpha, ps);
      if (lane == 0) alpha_s[h] = alpha;
    }
    __syncthreads();

    // 3) O = alpha O + P V over this thread's columns and heads
#pragma unroll
    for (int i = 0; i < G::HPV; ++i) {
      const int h = ph0 + G::HG * i;
      const float al = h < hb ? alpha_s[h] : 0.f;
#pragma unroll
      for (int x = 0; x < G::CPT; ++x) acc[i][x] *= al;
    }
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][G::CPT];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int x = 0; x < G::CPT; ++x)
          vv[jj][x] = elem_f32<KV>(vs + (j + jj) * RS + (pc + G::CT * x) * KB);
#pragma unroll
      for (int i = 0; i < G::HPV; ++i) {
        const int h = ph0 + G::HG * i;
        if (h >= hb) break;
        const float4 pv = *reinterpret_cast<const float4*>(sp + h * SP + j);
#pragma unroll
        for (int x = 0; x < G::CPT; ++x) {
          acc[i][x] = fmaf(pv.x, vv[0][x], acc[i][x]);
          acc[i][x] = fmaf(pv.y, vv[1][x], acc[i][x]);
          acc[i][x] = fmaf(pv.z, vv[2][x], acc[i][x]);
          acc[i][x] = fmaf(pv.w, vv[3][x], acc[i][x]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // each head's m and l (l summed over its warp's lanes)
#pragma unroll
  for (int u = 0; u < KH / 4; ++u) {
    const int h = warp + 4 * u;
    if (h >= hb) break;
    float l = lp[u];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      m_s[h] = m[u];
      l_s[h] = l;
    }
  }
  __syncthreads();
  // o, or this split's partial; a row with one used split is done here
  const long long pid = (long long)rowid * a.nsplit + split;   // this partial
#pragma unroll
  for (int i = 0; i < G::HPV; ++i) {
    const int h = ph0 + G::HG * i;
    if (h >= hb) break;
#pragma unroll
    for (int x = 0; x < G::CPT; ++x) {
      const int col = pc + G::CT * x;
      if (used == 1)
        out[h * D + col] = acc[i][x] / fmaxf(l_s[h], 1e-30f);
      else
        a.part_acc[(pid * KH + h) * D + col] = acc[i][x];
    }
  }
  if (used == 1) return;
  if (tid < hb) {
    a.part_ml[(pid * KH + tid) * 2] = m_s[tid];
    a.part_ml[(pid * KH + tid) * 2 + 1] = l_s[tid];
  }
  merge_splits<float, KH, D, kThreads>(a, ring, flag, rowid, used, hb, out, tid);
}

// ---- the split-D kernel -----------------------------------------------------

// One block a split; the nsplit blocks of a (b, kv head, head chunk) are one
// thread block cluster.  Each block pushes its partial into the shared
// memory of the blocks that merge it (distributed shared memory), the
// cluster meets once, and each block merges its slice of the output.
template <int KV, int D>
__global__ void __launch_bounds__(Split<D>::NT, 2)
flash_decode_split_kernel(const Args a) {
  using R = Ring<KV, D>;
  constexpr int DS = Split<D>::DS, NW = Split<D>::NW, NT = Split<D>::NT;
  constexpr int KH = Cfg<__nv_bfloat16>::kHeads;
  constexpr int BK = R::BK, S = R::kStages, EB = R::EB, TILE = R::kTile;
  constexpr int RB = D * EB;                        // bytes a landed row
  constexpr int CPR = RB / 16;                      // 16-byte chunks a landed row
  constexpr int NB = BK / 8;                        // S's 8-slot n-blocks a tile
  constexpr int NK = DS / 16;                       // S's k steps over a warp's columns
  constexpr int NJ = DS / 8;                        // O's 8-column n-blocks a warp
  constexpr int CPT = BK * CPR / NT;                // chunks of a K (or V) tile a thread loads
  constexpr int NBW = NB / NW;                      // 8-slot blocks whose softmax a warp takes
  static_assert(NB % NW == 0, "each warp takes whole 8-slot blocks of the softmax");
  static_assert(NT % CPR == 0 && (BK * CPR) % NT == 0, "a thread loads one column of chunks");

  const int split = (int)(blockIdx.x % a.nsplit);   // the block's rank in its cluster
  const int rowid = (int)(blockIdx.x / a.nsplit);   // (b * Hk + hk) * HC + hc
  const int hc = rowid % a.HC;
  const int bh = rowid / a.HC;
  const int hk = bh % a.Hk, b = bh / a.Hk;
  const int g = a.Hq / a.Hk;
  const int h0 = hk * g + hc * KH;                  // first q head of this block
  const int hb = min(KH, g - hc * KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;

  const long long row = (long long)a.Hk * D * EB;   // bytes from a slot of k (v) to the next
  const long long kv_off = ((long long)b * a.C * a.Hk + hk) * D * EB;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k) + kv_off;
  const unsigned char* vg = static_cast<const unsigned char*>(a.v) + kv_off;
  const int k_begin = split * a.split_keys;         // below C
  const int len = min(a.lengths[b], a.C);
  // q as the A operand over this warp's columns, in k_col's order (rows g
  // and g + 8 of the mma tiles are heads h0 + g and h0 + g + 8), its loads
  // in flight beside the length's
  uint32_t qa[NK][4];
  {
    const __nv_bfloat16* qh =
        static_cast<const __nv_bfloat16*>(a.q) + ((long long)b * a.Hq + h0) * D + warp * DS;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = gq + 8 * (e & 1);
        const int col = k_col<DS, EB>(t, 4 * kk + 2 * (e >> 1));
        qa[kk][e] = hr < hb ? *reinterpret_cast<const uint32_t*>(qh + hr * D + col) : 0u;
      }
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + ((long long)b * a.Hq + h0) * D;
  if (len < 1) {                                    // no valid slot: zeros
    if (split == 0)
      for (int e = tid; e < hb * D; e += NT) out[e] = __float2bfloat16(0.f);
    return;
  }
  const int used = (len + a.split_keys - 1) / a.split_keys;
  // one used split writes o itself, and the cluster never meets; past the
  // used splits a block only takes its slice of the merge
  if (used == 1 && split > 0) return;
  const int k_end = min(k_begin + a.split_keys, len);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  float4* sbuf = reinterpret_cast<float4*>(smem + R::kRing);    // (NW, NB, 32 lanes)
  uint4* pbuf = reinterpret_cast<uint4*>(sbuf + NW * NB * 32);  // (BK / 16, 32 lanes)
  float* rmax = reinterpret_cast<float*>(pbuf + BK / 16 * 32);  // (NW, KH)
  float* lsum = rmax + NW * KH;                                 // (NW, KH)
  // what the blocks of the cluster push here (see below)
  constexpr int NF = R::kParts;
  float4* recv = reinterpret_cast<float4*>(smem + R::kRing + R::kSBuf);   // (nsplit, per)
  float2* mlrecv = reinterpret_cast<float2*>(recv + NF + kMaxCluster);    // (kMaxCluster, KH)
  const int per = (NF + a.nsplit - 1) / a.nsplit;   // float4s a block merges
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();

  float o[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // m is the same in every warp; l is this lane's share of this warp's slots
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (k_begin < len) {
    // a tile lands as it is stored, its rows' chunks swizzled: this thread
    // copies chunk c of rows r0, r0 + NT/CPR, ..
    const int c = tid % CPR, r0 = tid / CPR;
    auto load_tile = [&](int stage, int k0) {
      unsigned char* ks = smem + stage * 2 * TILE;
      unsigned char* vs = ks + TILE;
      const long long base = (long long)k0 * row + c * 16;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int r = r0 + i * (NT / CPR);
        const bool valid = k0 + r < k_end;
        const long long off = valid ? base + r * row : 0;
        const int dst = r * RB + swz_split<CPR>(r, c) * 16;
        cp_async16(ks + dst, kg + off, valid);
        cp_async16(vs + dst, vg + off, valid);
      }
    };

    const int ntiles = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < (S > 1 ? S - 1 : 1); ++s) {
      if (s < ntiles) load_tile(s, k_begin + s * BK);
      cp_async_commit();
    }
    const int c0 = warp * DS * EB / 16;             // this warp's first chunk of a row
    for (int it = 0; it < ntiles; ++it) {
      if constexpr (S > 1) {
        cp_async_wait<S - 2>();   // tile `it` has landed, for this thread's copies
        __syncthreads();          // for every thread's; stage (it - 1) % S is free
        const int nt = it + S - 1;
        if (nt < ntiles) load_tile(nt % S, k_begin + nt * BK);
        cp_async_commit();
      } else {
        if (it > 0) {
          __syncthreads();        // every warp is done with the last tile
          load_tile(0, k_begin + it * BK);
          cp_async_commit();
        }
        cp_async_wait<0>();
        __syncthreads();
      }
      const unsigned char* ks = smem + (it % S) * 2 * TILE;
      const unsigned char* vs = ks + TILE;
      const int k0 = k_begin + it * BK;

      // this warp's columns' share of S = q K^T, every slot of the tile
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int r = 8 * nb + gq;
        uint32_t kb[2 * NK];
        lane_run<KV, CPR, DS / 4, 4>(ks + r * RB, r, c0, t, kb);
        float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) mma_bf16(x, qa[kk], kb[2 * kk], kb[2 * kk + 1]);
        sbuf[(warp * NB + nb) * 32 + lane] = make_float4(x[0], x[1], x[2], x[3]);
      }
      __syncthreads();
      // the softmax of this warp's NBW 8-slot blocks: S summed over the
      // warps' shares in one order; a lane holds slots 8nb + 2t, 8nb + 2t + 1
      // of rows g and g + 8
      float s[NBW][4];
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int u = 0; u < NBW; ++u) {
        const int nb = warp * NBW + u;
        float4 x = sbuf[nb * 32 + lane];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
          const float4 y = sbuf[(w * NB + nb) * 32 + lane];
          x.x += y.x;
          x.y += y.y;
          x.z += y.z;
          x.w += y.w;
        }
        const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * nb + 2 * t + (e & 1);
          s[u][e] = j < k_end ? v[e] * a.scale_log2 : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[u][e]);
        }
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
        mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
        if (t == 0) rmax[warp * KH + gq + 8 * rh] = mx[rh];
      }
      __syncthreads();
      // the tile's row maxima from every warp's, the same in every warp
      float alpha[2];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float M = rmax[gq + 8 * rh];
#pragma unroll
        for (int w = 1; w < NW; ++w) M = fmaxf(M, rmax[w * KH + gq + 8 * rh]);
        const float m_new = fmaxf(m[rh], M);
        alpha[rh] = exp2f(m[rh] - m_new);
        m[rh] = m_new;
        l[rh] *= alpha[rh];
      }
      // P of this warp's blocks, rounded to bf16, as words of the A operand
      // of the k step that holds them (words 0-1 an even block, 2-3 an odd)
#pragma unroll
      for (int u = 0; u < NBW; ++u) {
        const int nb = warp * NBW + u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + 8 * nb + 2 * t + (e & 1);
          const float p = j < k_end ? exp2f(s[u][e] - m[e >> 1]) : 0.f;
          s[u][e] = p;
          l[e >> 1] += p;
        }
        reinterpret_cast<uint2*>(pbuf + (nb >> 1) * 32 + lane)[nb & 1] =
            make_uint2(pack_bf16(s[u][0], s[u][1]), pack_bf16(s[u][2], s[u][3]));
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += P V over this warp's columns, 16 slots a k step; B's pairs are
      // rows (2t, 2t + 1) and (2t + 8, 2t + 9) at one column
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq) {
        const uint4 pq = pbuf[kq * 32 + lane];
        const uint32_t pa[4] = {pq.x, pq.y, pq.z, pq.w};
        uint32_t vw[4][NJ / 2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 16 * kq + 2 * t + (q & 1) + 8 * (q >> 1);
          lane_run<KV, CPR, DS / 8, 8>(vs + r * RB, r, c0, gq, vw[q]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;   // the high or the low halves
          mma_bf16(o[j], pa, __byte_perm(vw[0][j >> 1], vw[1][j >> 1], sel),
                   __byte_perm(vw[2][j >> 1], vw[3][j >> 1], sel));
        }
      }
    }
    cp_async_wait<0>();
    if (used > 1) {
      // acc pushed to the blocks of the cluster that merge it: float4 f of
      // it (warp, n-block j, lane, as the lanes hold it) to block f / per
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int f = (warp * NJ + j) * 32 + lane, owner = f / per;
        *cluster.map_shared_rank(recv + split * per + f - owner * per, owner) =
            make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
      }
    }
    // l summed over the lanes of a quad, then over the warps
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
      l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
    }
    if (t == 0) {
      lsum[warp * KH + gq] = l[0];
      lsum[warp * KH + gq + 8] = l[1];
    }
    __syncthreads();
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      l[rh] = lsum[gq + 8 * rh];
#pragma unroll
      for (int w = 1; w < NW; ++w) l[rh] += lsum[w * KH + gq + 8 * rh];
    }
  }

  // lane (g, t) holds o of heads g and g + 8 at this warp's columns
  // v_col(2t, j) and v_col(2t + 1, j); m and l of those heads, the same in
  // every warp
  if (used == 1) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int hr = gq + 8 * rh;
      if (hr >= hb) continue;
      const float L = fmaxf(l[rh], 1e-30f);
      __nv_bfloat16* dst = out + hr * D + warp * DS;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dst[v_col<DS, EB>(2 * t + e, j)] = __float2bfloat16(o[j][2 * rh + e] / L);
    }
    return;
  }

  // (m, l) of every head pushed to every block of the cluster, block
  // 4 warp + t by the lanes of quad t (acc was, as the loop ended)
  if (k_begin < len && warp * 4 + t < a.nsplit) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      *cluster.map_shared_rank(mlrecv + split * KH + gq + 8 * rh, warp * 4 + t) =
          make_float2(m[rh], l[rh]);
  }
  cluster.sync();             // every push has landed; no block reads another's memory after

  // each head's weight for each used split, 2^(m_s - M), and its sum L,
  // once a head into the ring (free: every block is past its loop)
  float* fs = reinterpret_cast<float*>(smem);       // (kMaxCluster, KH)
  float* Ls = fs + kMaxCluster * KH;                // (KH)
  if (tid < KH) {
    float M = kNegInf;
    float2 ml[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (s < used) {
        ml[s] = mlrecv[s * KH + tid];
        M = fmaxf(M, ml[s].x);
      }
    float L = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (s < used) {
        const float f = exp2f(ml[s].x - M);
        fs[s * KH + tid] = f;
        L = fmaf(f, ml[s].y, L);
      }
    Ls[tid] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  // this block's slice, float4s [split * per, (split + 1) * per) of the
  // partials: the used splits' float4s weighted, then written where the
  // lane that held them would write them
  const int end = min(NF, (split + 1) * per);
  for (int f = split * per + tid; f < end; f += NT) {
    const int w = f / (NJ * 32), j = f / 32 % NJ, fg = f % 32 >> 2, ft = f % 4;
    float4 x[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (s < used) x[s] = recv[s * per + f - split * per];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (s < used) {
        const float f0 = fs[s * KH + fg], f1 = fs[s * KH + fg + 8];
        acc.x = fmaf(f0, x[s].x, acc.x);
        acc.y = fmaf(f0, x[s].y, acc.y);
        acc.z = fmaf(f1, x[s].z, acc.z);
        acc.w = fmaf(f1, x[s].w, acc.w);
      }
    const int d0 = w * DS + v_col<DS, EB>(2 * ft, j), d1 = w * DS + v_col<DS, EB>(2 * ft + 1, j);
    if (fg < hb) {
      out[fg * D + d0] = __float2bfloat16(acc.x / Ls[fg]);
      out[fg * D + d1] = __float2bfloat16(acc.y / Ls[fg]);
    }
    if (fg + 8 < hb) {
      out[(fg + 8) * D + d0] = __float2bfloat16(acc.z / Ls[fg + 8]);
      out[(fg + 8) * D + d1] = __float2bfloat16(acc.w / Ls[fg + 8]);
    }
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

template <int KV, int D>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t st) {
  constexpr int smem = F32Tile<KV, D>::kSmem;
  // the cross-split merge keeps a weight a (split, head) in the ring
  if ((a.nsplit + 1) * F32Tile<KV, D>::KH * (int)sizeof(float) > 2 * F32Tile<KV, D>::TILE)
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e = set_smem_once(flash_decode_f32_kernel<KV, D>, smem, smem_set, true);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)B * a.Hk * a.HC * a.nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_decode_f32_kernel<KV, D><<<(unsigned)blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int KV, int D>
cudaError_t launch_split(const Args& a, int B, cudaStream_t st) {
  using R = Ring<KV, D>;
  if (a.nsplit > kMaxCluster) return cudaErrorInvalidValue;   // a row's splits are one cluster
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t e =
      set_smem_once(flash_decode_split_kernel<KV, D>, R::kSmem, smem_set, true, true);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)B * a.Hk * a.HC * a.nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(Split<D>::NT);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_split_kernel<KV, D>, a);
}

// A bf16 q at D = 256 takes the split-D kernel; the rest the slot-split one.
template <typename T, int KV, int D>
constexpr bool uses_split() {
  return std::is_same<T, __nv_bfloat16>::value && D == 256;
}

// What the entry points below do with the variant for (T, KV, D).
struct LaunchVariant {
  const Args& a;
  int B;
  cudaStream_t st;
  template <typename T, int KV, int D> int run() const {
    if constexpr (uses_split<T, KV, D>()) return launch_split<KV, D>(a, B, st);
    else if constexpr (std::is_same<T, float>::value) return launch_f32<KV, D>(a, B, st);
    else return launch<T, KV, D>(a, B, st);
  }
};
struct SmemVariant {
  template <typename T, int KV, int D> int run() const {
    if constexpr (uses_split<T, KV, D>()) return Ring<KV, D>::kSmem;
    else if constexpr (std::is_same<T, float>::value) return F32Tile<KV, D>::kSmem;
    else return smem_bytes_for<T, KV, D>();
  }
};
template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem, bool max_shared, bool clustered) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && max_shared)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && clustered)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return e == cudaSuccess ? n : -1;
}
struct MaxSplitsVariant {
  template <typename T, int KV, int D> int run() const {
    return uses_split<T, KV, D>() ? kMaxCluster : 0;
  }
};
struct OccupancyVariant {
  template <typename T, int KV, int D> int run() const {
    if constexpr (uses_split<T, KV, D>())
      return occupancy(flash_decode_split_kernel<KV, D>, Split<D>::NT, Ring<KV, D>::kSmem, true,
                       true);
    else if constexpr (std::is_same<T, float>::value)
      return occupancy(flash_decode_f32_kernel<KV, D>, kThreads, F32Tile<KV, D>::kSmem, true,
                       false);
    else
      return occupancy(flash_decode_kernel<T, KV, D>, kThreads, smem_bytes_for<T, KV, D>(), false,
                       false);
  }
};

template <typename T, int KV, typename F>
int on_d(int D, const F& f, int none) {
  switch (D) {
    case 32: return f.template run<T, KV, 32>();
    case 64: return f.template run<T, KV, 64>();
    case 128: return f.template run<T, KV, 128>();
    case 256: return f.template run<T, KV, 256>();
    default: return none;
  }
}

// f.run<T, KV, D>() for the variant built for (D, kv_kind), else `none`
template <typename T, typename F>
int on_variant(int D, int kv_kind, const F& f, int none) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  switch (kv_kind) {
    case kKvSame: return on_d<T, kKvSame>(D, f, none);
    case kKvE4M3: return on_d<T, kKvE4M3>(D, f, none);
    case kKvE5M2: return on_d<T, kKvE5M2>(D, f, none);
    case kKvF16: return on_d<T, kKvF16>(D, f, none);
    case kKvBF16:
      if constexpr (kF32) return on_d<T, kKvBF16>(D, f, none);
      else return none;                     // bf16 under bf16 q is kind 0
    case kKvF32:
      if constexpr (!kF32) return on_d<T, kKvF32>(D, f, none);
      else return none;                     // f32 under f32 q is kind 0
    default: return none;
  }
}

}  // namespace

// q, o: (B, Hq, D) float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); k, v:
// (B, C, Hk, D) in q's dtype (kv_kind = 0), float8_e4m3fn (1), float8_e5m2
// (2), bfloat16 under f32 q (3), float16 (4) or float32 under bf16 q (5);
// all contiguous and 16-byte aligned; lengths: (B,)
// int32.  Scratch for the slot-split variants (the split-D ones merge in
// shared memory and leave it unread), with HC = ceil(g /
// flash_decode_heads_per_block) and rows = B * Hk * HC: part_acc (rows,
// nsplit, heads_per_block, D) and part_ml (rows, nsplit, heads_per_block, 2)
// float32; counters (rows,) int32, all zero before the first call (each
// call leaves them zero).  nsplit * split_keys >= C, split_keys a multiple
// of 64, nsplit at most flash_decode_max_splits.  D in {32, 64, 128, 256},
// Hq % Hk == 0.  Calls that share scratch must be ordered on one stream.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* part_acc,
                                void* part_ml, void* counters, int B, int C, int Hq, int Hk,
                                int D, int split_keys, int nsplit, float scale, int is_bf16,
                                int kv_kind, void* stream) {
  if (B < 1 || C < 1 || Hq < 1 || Hk < 1 || Hq % Hk != 0 || split_keys < kBK ||
      split_keys % kBK != 0 || nsplit < 1 || (long long)nsplit * split_keys < C)
    return cudaErrorInvalidValue;
  const int kh = heads_per_block(D, is_bf16);
  const int g = Hq / Hk;
  Args a{q, k, v, static_cast<const int*>(lengths), o, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), static_cast<int*>(counters), C, Hq, Hk,
         (g + kh - 1) / kh, split_keys, nsplit, scale * 1.4426950408889634f};
  const LaunchVariant f{a, B, static_cast<cudaStream_t>(stream)};
  constexpr int none = cudaErrorInvalidValue;
  if (is_bf16) return on_variant<__nv_bfloat16>(D, kv_kind, f, none);
  return on_variant<float>(D, kv_kind, f, none);
}

// Query heads one block holds (the head chunk) at head size D: bf16 16,
// float32 16 (8 at D = 256); -1 if D is not built.
extern "C" int flash_decode_heads_per_block(int D, int is_bf16) {
  if (D != 32 && D != 64 && D != 128 && D != 256) return -1;
  return heads_per_block(D, is_bf16);
}

// Dynamic shared memory one block takes at head size D for K/V of kv_kind,
// in bytes; -1 if D or kv_kind is not built.
extern "C" int flash_decode_smem_bytes(int D, int is_bf16, int kv_kind) {
  return is_bf16 ? on_variant<__nv_bfloat16>(D, kv_kind, SmemVariant{}, -1)
                 : on_variant<float>(D, kv_kind, SmemVariant{}, -1);
}

// Blocks of the variant for (D, q's dtype, kv_kind) that one SM of the
// current device holds at once, by cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at its threads and shared memory; -1 if it is not built or on a CUDA error.
extern "C" int flash_decode_blocks_per_sm(int D, int is_bf16, int kv_kind) {
  return is_bf16 ? on_variant<__nv_bfloat16>(D, kv_kind, OccupancyVariant{}, -1)
                 : on_variant<float>(D, kv_kind, OccupancyVariant{}, -1);
}

// The most splits a row may take in the variant for (D, q's dtype,
// kv_kind): 16 where a row's splits are one cluster, 0 for no limit; -1 if
// it is not built.
extern "C" int flash_decode_max_splits(int D, int is_bf16, int kv_kind) {
  return is_bf16 ? on_variant<__nv_bfloat16>(D, kv_kind, MaxSplitsVariant{}, -1)
                 : on_variant<float>(D, kv_kind, MaxSplitsVariant{}, -1);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
