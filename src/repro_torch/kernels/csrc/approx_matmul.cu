// K1: approximate-multiplier matmul, out[m, n] = sum_k LUT[a[m, k], b[k, n]].
//
// Replaces the Pallas TPU kernel `approx_matmul_kernel_call`
// (src/repro/kernels/approx_matmul/kernel.py, body `_kernel`), which
// evaluates the same sum as A@B - sum_f v_f(A) @ u_f(B) on the MXU with
// f32 tiles of bk <= 256 so every tile sum stays exact.
//
// This kernel takes the direct route instead: the multiplier's 256x256 LUT
// (every registered design fits in uint16: values <= 65025) sits in 128 KB
// of dynamic shared memory, A/B code tiles are staged through shared
// memory, and each thread sums LUT[a][b] for a TMxTN micro-tile in int32
// registers.  int32 accumulation is exact for K * 65025 < 2**31, i.e.
// K <= 33025, so no tiling constraint on K remains.  Ragged M/N/K are
// masked here (out-of-range k loads code 0 on both sides and LUT[0][0] == 0
// for every design); rows/columns past M/N are never stored.
//
// What bounds it on an H100: one shared-memory LUT read per MAC.  The LUT
// leaves room for one block per SM, and the reads land on banks chosen by
// the weight code, so the kernel is bound by shared-memory lookups, not by
// HBM (it moves only the uint8 codes and the int32 output).  What the
// design does about it: small-M (decode) calls use row tiles of 4 or 16 so
// no lookups are spent on padding rows, and split-K over grid.z (int32
// atomicAdd, exact in any order) fills the SMs when M*N alone gives too few
// tiles.  The u8 tensor-core form (A@B in s32 plus the feature dots) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLutEntries = 256 * 256;
constexpr int kLutBytes = kLutEntries * 2;
constexpr int kBK = 32;

template <int BM, int BN, int TM, int TN>
__host__ __device__ constexpr int threads_of() { return (BM / TM) * (BN / TN); }

template <int BM, int BN, int TM, int TN>
__host__ __device__ constexpr int smem_bytes() { return kLutBytes + kBK * BM + kBK * BN; }

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(threads_of<BM, BN, TM, TN>())
approx_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                     const uint16_t* __restrict__ lut, int32_t* __restrict__ out,
                     int M, int N, int K, int k_per_split) {
  constexpr int kThreads = threads_of<BM, BN, TM, TN>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s_a = smem + kLutBytes;   // [kBK][BM], k-major so a row's codes broadcast
  uint8_t* s_b = s_a + kBK * BM;     // [kBK][BN]

  const int tid = threadIdx.x;
  {
    const uint4* src = reinterpret_cast<const uint4*>(lut);
    uint4* dst = reinterpret_cast<uint4*>(s_lut);
    for (int i = tid; i < kLutBytes / 16; i += kThreads) dst[i] = src[i];
  }

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  int32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile fully read (and, first time, LUT copy issued)
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int mm = i / kBK, kk = i % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      s_a[kk * BM + mm] = (gm < M && gk < k_end) ? a[(size_t)gm * K + gk] : 0;
    }
    for (int i = tid; i < kBK * BN; i += kThreads) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      s_b[kk * BN + nn] = (gk < k_end && gn < N) ? b[(size_t)gk * N + gn] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      int bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = s_b[kk * BN + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const uint16_t* row = s_lut + (static_cast<int>(s_a[kk * BM + ty * TM + i]) << 8);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += row[bv[j]];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) atomicAdd(&out[(size_t)gm * N + gn], acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const uint8_t* a, const uint8_t* b, const uint16_t* lut, int32_t* out,
                   int M, int N, int K, cudaStream_t stream) {
  auto kernel = approx_matmul_kernel<BM, BN, TM, TN>;
  constexpr int smem = smem_bytes<BM, BN, TM, TN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int gx = (N + BN - 1) / BN;
  const int gy = (M + BM - 1) / BM;
  const int k_tiles = (K + kBK - 1) / kBK;
  // one resident block per SM (the LUT takes 128 KB): aim for two waves
  int splits = (2 * sms) / (gx * gy);
  splits = splits < 1 ? 1 : (splits > k_tiles ? k_tiles : splits);
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + tiles_per_split - 1) / tiles_per_split;
  dim3 grid(gx, gy, splits);
  kernel<<<grid, threads_of<BM, BN, TM, TN>(), smem, stream>>>(
      a, b, lut, out, M, N, K, tiles_per_split * kBK);
  return cudaGetLastError();
}

}  // namespace

// out must be zero-filled (split-K partial sums are added atomically).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int approx_matmul_launch(const void* a, const void* b, const void* lut,
                                    void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  auto* a8 = static_cast<const uint8_t*>(a);
  auto* b8 = static_cast<const uint8_t*>(b);
  auto* l16 = static_cast<const uint16_t*>(lut);
  auto* o32 = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 4) return launch<4, 256, 1, 4>(a8, b8, l16, o32, M, N, K, s);
  if (M <= 16) return launch<16, 128, 2, 4>(a8, b8, l16, o32, M, N, K, s);
  return launch<64, 64, 4, 4>(a8, b8, l16, o32, M, N, K, s);
}
