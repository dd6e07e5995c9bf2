// Exact three-way bfloat16 split of a float32 matrix, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces no TPU kernel.  The JAX model computes the head's logits from
// bf16 operands into float32 (preferred_element_type) and XLA derives the
// backward.  On the H100 the port's head runs that product on the tensor
// cores (torch.mm with out_dtype=float32), and its backward has to bring the
// float32 cotangent G of the logits to those same units without rounding
// it.  So G goes in as three bf16 pieces whose sum is G:
//
//   hi = bf16(G),   mid = bf16(G - hi),   lo = bf16(G - hi - mid)
//
// each rounded to nearest even.  G - hi is exact in float32 and lies within
// half a bf16 step of 0 (|G - hi| <= 2^(e-8) for 2^e <= |G| < 2^(e+1)), a
// multiple of G's last bit 2^(e-23): at most 16 significant bits.  mid takes
// the top 8 of them, and G - hi - mid, again exact, keeps at most 8, which
// bf16 holds: hi + mid + lo == G bit for bit.  That holds where lo's last
// bit, 2^(e-23), is no finer than bf16's least subnormal 2^-133, so for
// |G| >= 2^-110 and for zero; below, lo rounds to a multiple of 2^-133.
// Built without fast math: the subtractions keep subnormals.
//
// What bounds it on this card: bytes.  Each element is read once (4 bytes)
// and its pieces written once (6 bytes), 10 bytes an element at 3.35 TB/s;
// three flops an element are nothing beside them.  The design: one pass,
// each thread taking four neighbouring elements of a row (one 16-byte
// streaming load, three 8-byte stores), so a warp's loads and stores are
// whole 128-byte lines; a grid-stride loop over the matrix.  A matrix whose
// rows are not 16-byte aligned takes one element a thread.
//
// Layout: G is (rows, cols) float32 with a row stride of ld elements (a
// column block of a wider matrix); out is (rows, 3, cols) bf16, contiguous:
// row r's hi at out[r*3*cols + c], mid at + cols, lo at + 2*cols.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kSms = 132;

__device__ __forceinline__ void split(float g, unsigned short& hi, unsigned short& mid,
                                      unsigned short& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(g);
  const float r = g - __bfloat162float(h);
  const __nv_bfloat16 m = __float2bfloat16_rn(r);
  hi = __bfloat16_as_ushort(h);
  mid = __bfloat16_as_ushort(m);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(r - __bfloat162float(m)));
}

__device__ __forceinline__ uint2 pack(const unsigned short* v) {
  return make_uint2(v[0] | (unsigned)v[1] << 16, v[2] | (unsigned)v[3] << 16);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
bf16_split3_kernel(const float* __restrict__ g, long long ld, unsigned short* __restrict__ out,
                   int rows, int cols) {
  const long long per_row = cols / kVec;
  const long long n = per_row * rows;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const long long r = i / per_row;
    const long long c = (i - r * per_row) * kVec;
    const float* src = g + r * ld + c;
    unsigned short* dst = out + r * 3LL * cols + c;
    unsigned short p[3][kVec];
    if constexpr (kVec == 4) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(src));
      split(x.x, p[0][0], p[1][0], p[2][0]);
      split(x.y, p[0][1], p[1][1], p[2][1]);
      split(x.z, p[0][2], p[1][2], p[2][2]);
      split(x.w, p[0][3], p[1][3], p[2][3]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint2*>(dst + (long long)k * cols) = pack(p[k]);
    } else {
      split(__ldcs(src), p[0][0], p[1][0], p[2][0]);
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[(long long)k * cols] = p[k][0];
    }
  }
}

template <int kVec>
cudaError_t launch(const float* g, long long ld, unsigned short* out, int rows, int cols,
                   cudaStream_t st) {
  const long long items = (long long)rows * (cols / kVec);
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (long long)kSms * kBlocksPerSm) blocks = (long long)kSms * kBlocksPerSm;
  bf16_split3_kernel<kVec><<<(unsigned)blocks, kThreads, 0, st>>>(g, ld, out, rows, cols);
  return cudaGetLastError();
}

}  // namespace

// g: (rows, cols) float32, row stride ld elements, unit column stride;
// out: (rows, 3, cols) bfloat16, contiguous.  rows, cols >= 1, ld >= cols.
extern "C" int bf16_split3(const void* g, long long ld, void* out, int rows, int cols,
                           void* stream) {
  if (rows < 1 || cols < 1 || ld < cols) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(g);
  unsigned short* dst = static_cast<unsigned short*>(out);
  const bool vec = cols % 4 == 0 && ld % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  return vec ? launch<4>(src, ld, dst, rows, cols, st) : launch<1>(src, ld, dst, rows, cols, st);
}

extern "C" const char* bf16_split3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
