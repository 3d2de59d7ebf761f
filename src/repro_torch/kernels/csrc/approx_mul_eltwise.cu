// K3: elementwise approximate 8x8 multiply, out[i] = MUL8x8(a[i], b[i]),
// for the paper's mul8x8_1, mul8x8_2 and mul8x8_3.
//
// Replaces the Pallas TPU kernel `approx_mul_eltwise_call`
// (src/repro/kernels/approx_mul_eltwise/kernel.py, body `_kernel`), which
// tiles the flattened operands into (block,) VMEM blocks, pads the tail to
// a whole block, and evaluates the bit logic of core/logic.py on the VPU.
//
// Here the same bit logic runs per element in registers: each 3x3 partial
// product is the exact product minus the six-row K-map correction, found
// by compares and masks, and the nine partial products (M2 dropped for
// mul8x8_3) plus the exact 2x2 M8 are shifted and added.  No LUT is read:
// the kernel is an independent derivation of the table that K1 loads, which
// is what it is for.  Design and M2 are template parameters, so each
// variant compiles to straight-line integer code without branches.
//
// What bounds it on an H100: it moves 2 bytes in and 4 bytes out per
// element (3.35 TB/s), and spends some 150 integer operations per element
// on the bit logic, so the integer pipes and not device memory may well be
// the limit.  What the design does about it: a grid-stride loop where each
// thread loads four codes of a and of b as one 32-bit word each and stores
// the four int32 results as one 16-byte int4, so every access is
// coalesced and wide; the ragged tail (n % 4 elements) is done by the
// first threads of each block's last pass.  No padding is needed: any
// element count is taken as it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int kDesign>
__device__ __forceinline__ int mul3x3(int a, int b) {
  const int exact = a * b;
  const int m57 = ((a == 5) & (b == 7)) | ((a == 7) & (b == 5));
  const int m66 = (a == 6) & (b == 6);
  const int m67 = ((a == 6) & (b == 7)) | ((a == 7) & (b == 6));
  const int m77 = (a == 7) & (b == 7);
  if (kDesign == 1) return exact - 8 * m57 - 12 * m66 - 12 * m67 - 20 * m77;
  return exact - 8 * m57 + 4 * (m66 + m67) - 4 * m77;
}

template <int kDesign, bool kRemovedM2>
__device__ __forceinline__ int mul8x8(int a, int b) {
  const int alo = a & 7, amid = (a >> 3) & 7, ahi = (a >> 6) & 3;
  const int blo = b & 7, bmid = (b >> 3) & 7, bhi = (b >> 6) & 3;
  int out = mul3x3<kDesign>(alo, blo)
          + (mul3x3<kDesign>(alo, bmid) << 3) + (mul3x3<kDesign>(amid, blo) << 3)
          + (mul3x3<kDesign>(amid, bmid) << 6)
          + (mul3x3<kDesign>(amid, bhi) << 9) + (mul3x3<kDesign>(ahi, bmid) << 9)
          + ((ahi * bhi) << 12)
          + (mul3x3<kDesign>(ahi, blo) << 6);
  if (!kRemovedM2) out += mul3x3<kDesign>(alo, bhi) << 6;
  return out;
}

template <int kDesign, bool kRemovedM2>
__global__ void __launch_bounds__(256)
approx_mul_eltwise_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                          int32_t* __restrict__ out, long long n) {
  const long long n4 = n >> 2;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint32_t* a4 = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* b4 = reinterpret_cast<const uint32_t*>(b);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (long long i = gid; i < n4; i += stride) {
    const uint32_t av = __ldg(a4 + i);
    const uint32_t bv = __ldg(b4 + i);
    int4 r;
    r.x = mul8x8<kDesign, kRemovedM2>(av & 255u, bv & 255u);
    r.y = mul8x8<kDesign, kRemovedM2>((av >> 8) & 255u, (bv >> 8) & 255u);
    r.z = mul8x8<kDesign, kRemovedM2>((av >> 16) & 255u, (bv >> 16) & 255u);
    r.w = mul8x8<kDesign, kRemovedM2>(av >> 24, bv >> 24);
    o4[i] = r;
  }
  const long long t = (n4 << 2) + gid;   // the n % 4 elements past the last word
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
  const int threads = 256;
  const long long n4 = n >> 2;
  long long blocks = (n4 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;       // grid-stride beyond 16 waves
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (design == 1)
    approx_mul_eltwise_kernel<1, false><<<grid, threads, 0, s>>>(pa, pb, po, n);
  else if (removed_m2)
    approx_mul_eltwise_kernel<2, true><<<grid, threads, 0, s>>>(pa, pb, po, n);
  else
    approx_mul_eltwise_kernel<2, false><<<grid, threads, 0, s>>>(pa, pb, po, n);
  return static_cast<int>(cudaGetLastError());
}
