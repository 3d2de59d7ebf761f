// K3: elementwise approximate 8x8 multiply, out[i] = MUL8x8(a[i], b[i]),
// for the paper's mul8x8_1, mul8x8_2 and mul8x8_3.
//
// Replaces the Pallas TPU kernel `approx_mul_eltwise_call`
// (src/repro/kernels/approx_mul_eltwise/kernel.py, body `_kernel`), which
// tiles the flattened operands into (block,) VMEM blocks, pads the tail to
// a whole block, and evaluates the bit logic of core/logic.py on the VPU.
//
// Here the same function is evaluated per element in registers, with the
// work cut to what can differ from the exact product.  The 8x8 product is
// the shift-add of nine 3x3 partial products (M8, ahi * bhi, is an exact
// 2x2), and a 3x3 block errs only where both operands are >= 5 (the K-map
// rows of core/logic.py: (5,7)/(7,5), (6,6), (6,7)/(7,6), (7,7)).  ahi and
// bhi are <= 3, so only (alo,blo), (alo,bmid), (amid,blo) and (amid,bmid)
// can err, and
//
//   MUL8x8(a, b) = a*b - c(alo,blo) - c(alo,bmid)<<3 - c(amid,blo)<<3
//                      - c(amid,bmid)<<6  [- (alo*bhi)<<6 for mul8x8_3]
//
// (mul8x8_3 drops M2 = alo*bhi, which never errs).  With x = 4 + x', y =
// 4 + y' for x, y >= 5, P = x'y' is 1 on (5,5), 2 on (5,6)/(6,5), 3 on
// (5,7)/(7,5), 4 on (6,6), 6 on (6,7)/(7,6) and 9 on (7,7), so the K-map's
// correction is a step function of P: design 1 subtracts 8, 12, 12, 20 at
// P = 3, 4, 6, 9 (c = 4 * (2[P>=3] + [P>=4] + 2[P>=9])), design 2 subtracts
// 8, -4, -4, 4 (c = 4 * (2[P>=3] - 3[P>=4] + 2[P>=9])); P is forced to 0
// unless bit 2 of both fields is set (x = 4 gives x' = 0 by itself).  No
// LUT is read: the kernel is an independent derivation of the table that
// K1 loads, which is what it is for.  Design and M2 are template
// parameters, so each variant compiles to straight-line integer code.
//
// What bounds it on an H100: it moves 2 bytes in and 4 bytes out per
// element (3.35 TB/s); the integer work per element (four corrections
// instead of nine 3x3 products with their compare chains) should now sit
// under the byte time.  What the design does about the bytes: a
// grid-stride loop over tiles of 4,096 codes per block, where each thread
// issues the loads of 16 codes of a and of b (four 32-bit words each,
// 256 threads apart, so each warp-wide load and each int4 store is
// contiguous) before it computes, and stores its 16 int32 results as four
// 16-byte int4; the ragged tail (n % 4 elements) is done by the first
// threads of the first block.  No padding is
// needed: any element count is taken as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// c(x, y) of the 3x3 block: x, y are 3-bit fields, the result what the
// design subtracts from the exact x*y
template <int kDesign>
__device__ __forceinline__ int corr(int x, int y) {
  const int P = ((x & y) >> 2 & 1) * ((x & 3) * (y & 3));
  const int ge3 = P >= 3, ge4 = P >= 4, ge9 = P >= 9;
  return kDesign == 1 ? 4 * (2 * ge3 + ge4 + 2 * ge9) : 4 * (2 * ge3 - 3 * ge4 + 2 * ge9);
}

template <int kDesign, bool kRemovedM2>
__device__ __forceinline__ int mul8x8(int a, int b) {
  const int alo = a & 7, amid = (a >> 3) & 7;
  const int blo = b & 7, bmid = (b >> 3) & 7;
  int out = a * b - corr<kDesign>(alo, blo)
          - ((corr<kDesign>(alo, bmid) + corr<kDesign>(amid, blo)) << 3)
          - (corr<kDesign>(amid, bmid) << 6);
  if (kRemovedM2) out -= (alo * (b >> 6)) << 6;
  return out;
}

template <int kDesign, bool kRemovedM2>
__device__ __forceinline__ int4 mul4(uint32_t a, uint32_t b) {
  int4 r;
  r.x = mul8x8<kDesign, kRemovedM2>(a & 255u, b & 255u);
  r.y = mul8x8<kDesign, kRemovedM2>((a >> 8) & 255u, (b >> 8) & 255u);
  r.z = mul8x8<kDesign, kRemovedM2>((a >> 16) & 255u, (b >> 16) & 255u);
  r.w = mul8x8<kDesign, kRemovedM2>(a >> 24, b >> 24);
  return r;
}

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;                 // 16 codes of a and of b
constexpr int kTile = kThreads * kWordsPerThread;  // 32-bit words per block and pass

template <int kDesign, bool kRemovedM2>
__global__ void __launch_bounds__(kThreads)
approx_mul_eltwise_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                          int32_t* __restrict__ out, long long n) {
  const long long n4 = n >> 2;
  const uint32_t* a4 = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* b4 = reinterpret_cast<const uint32_t*>(b);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < n4;
       base += static_cast<long long>(gridDim.x) * kTile) {
    uint32_t av[kWordsPerThread], bv[kWordsPerThread];
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const long long w = base + k * kThreads + threadIdx.x;
      av[k] = w < n4 ? __ldg(a4 + w) : 0u;
      bv[k] = w < n4 ? __ldg(b4 + w) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      const long long w = base + k * kThreads + threadIdx.x;
      if (w < n4) o4[w] = mul4<kDesign, kRemovedM2>(av[k], bv[k]);
    }
  }
  // the n % 4 elements past the last word
  const long long t = (n4 << 2) + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < n) out[t] = mul8x8<kDesign, kRemovedM2>(a[t], b[t]);
}

}  // namespace

// a, b: n uint8 codes each, 4-byte aligned; out: n int32, 16-byte aligned.
// design 1 or 2 (the 3x3 block), removed_m2 0 or 1.  Launches on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for arguments the
// kernel does not take, cudaErrorMisalignedAddress for misaligned buffers).
extern "C" int approx_mul_eltwise_launch(const void* a, const void* b, void* out,
                                         long long n, int design, int removed_m2,
                                         void* stream) {
  if (n <= 0 || (design != 1 && design != 2) || (design == 1 && removed_m2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(a) % 4 || reinterpret_cast<uintptr_t>(b) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long n4 = n >> 2;
  long long blocks = (n4 + kTile - 1) / kTile;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;       // grid-stride beyond 16 waves
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (design == 1)
    approx_mul_eltwise_kernel<1, false><<<grid, kThreads, 0, s>>>(pa, pb, po, n);
  else if (removed_m2)
    approx_mul_eltwise_kernel<2, true><<<grid, kThreads, 0, s>>>(pa, pb, po, n);
  else
    approx_mul_eltwise_kernel<2, false><<<grid, kThreads, 0, s>>>(pa, pb, po, n);
  return static_cast<int>(cudaGetLastError());
}
