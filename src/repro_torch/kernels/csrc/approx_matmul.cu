// K1: approximate-multiplier matmul on Hopper's integer tensor cores,
// out[m, n] = sum_k LUT[a[m, k], b[k, n]] as int32, bit for bit.
//
// Replaces the Pallas TPU kernel `approx_matmul_kernel_call`
// (src/repro/kernels/approx_matmul/kernel.py:85, body `_kernel` :54-78),
// which evaluates the same sum through the exact decomposition of the
// multiplier's error, out = A@B - sum_f v_f(A) @ u_f(B), on the matrix unit
// with the feature maps computed in the kernel from the code tiles.
//
// Here every term is an 8-bit operand: the wrapper (approx_matmul/ops.py,
// `feature_tables`) rescales the features to
//     out = A@B - c * sum_f vt_f(A) @ u'_f(B)
// with vt_f a 256-entry map on the activation code that fits s8 (or u8
// where it spans 0..255) and u'_f a map on the weight code that fits u8.
// So the exact product is one u8 x u8 product and each feature one s8/u8 x
// u8 product, all with s32 accumulation (no .satfinite: sums wrap, and the
// epilogue combines in two's-complement 32-bit arithmetic; the true result
// fits int32 since K * 65025 < 2^31, so it is exact in any order).
//
// What bounds it on an H100: the work is (1 + F) * 2*M*N*K integer
// tensor-core operations (F <= 7; 6 for the served mul8x8_2) against
// M*K + K*N code bytes in and 4*M*N bytes out, so calls with M >= 64 are
// bound by operations and decode calls (M = 4) by the weight bytes.  What
// bounds this kernel as written is shared memory: per element and k-tile
// the mapping pass makes one table lookup and 1 + F operand stores, which
// wgmma then reads back, more traffic than the tensor cores' work takes.
// What the design does about it:
//   * raw uint8 code tiles arrive by cp.async into a ring of kStages slots;
//     the activation tile lands directly in the core-matrix layout wgmma
//     reads, so A@B's left operand needs no pass at all;
//   * a mapping pass reads each raw element once and writes all of its
//     operand bytes through one 8-byte lookup in a packed table (one lookup
//     per element per k-tile, not per MAC), kept in 16 copies so that a
//     half-warp's lookups never share a bank; the weight tile (K, N), N
//     contiguous, is transposed on the way, since 8-bit wgmma takes both
//     operands K-major, with stores spread over all 32 banks; no transposed
//     copy of the weights is ever stored;
//   * wgmma.mma_async into two s32 accumulators (A@B and the feature sum)
//     runs on one mapped buffer while the threads map the next k-tile into
//     the other;
//   * M >= 64: 128x128 output tiles, two warpgroups of 64 rows each;
//     M < 64 (decode): operands swapped, out^T = B^T A^T, so the weight
//     columns fill wgmma's 64 rows and M pads only to n = 8/16/32/64;
//   * split-K over grid.z, sized to one wave of resident blocks, with
//     32-bit atomics into a zeroed output when there are too few tiles;
//   * the feature count NF and the number NU of u8 activation maps (the
//     wrapper puts them first) are template parameters, so the wgmma
//     sequence of a k-tile is straight-line code.
// Ragged edges: the wrapper pads K (and B's row stride) to a multiple of 16
// with code 0; rows past M and chunks past N or K are zero-filled by
// cp.async, and LUT[0][0] == 0 with every feature term vanishing at (0, 0),
// so padding adds nothing.  Stores are masked to M x N.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;       // k bytes per tile: one wgmma k-step for 8-bit operands
constexpr int kBN = 128;      // weight columns per block
constexpr int kStages = 4;    // raw-tile ring depth
constexpr int kThreads = 256; // two warpgroups
constexpr int kMaxF = 7;      // features; 1 + kMaxF bytes fill a packed table entry
constexpr int kRep = 16;      // table copies: lane l of a half-warp reads copy l
constexpr int kRepTabBytes = 256 * kRep * 8;
constexpr int kMinTilesPerSplit = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Keeps the compiler from moving reads of an accumulator across the wait.
template <int NR>
__device__ __forceinline__ void fence_acc(int32_t (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: K-major core matrices of
// 8 rows x 16 bytes, each 128 contiguous bytes; the next core matrix along
// K is 128 bytes on (leading byte offset), the next 8 rows 256 bytes on
// (stride byte offset).  A tile of R rows x 32 k-bytes is [R/8][2][8][16].
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

#define K1_ACC4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define K1_ACC8(d, i) K1_ACC4(d, i), K1_ACC4(d, i + 4)
#define K1_ACC16(d, i) K1_ACC8(d, i), K1_ACC8(d, i + 8)
#define K1_ACC32(d, i) K1_ACC16(d, i), K1_ACC16(d, i + 16)
#define K1_ACC64(d, i) K1_ACC32(d, i), K1_ACC32(d, i + 32)

#define K1_REGS4 "{%0, %1, %2, %3}"
#define K1_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define K1_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define K1_REGS32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define K1_REGS64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// One m64nNk32 product into s32 accumulators: D += A * B, A (64 x 32) and
// B (N x 32) K-major in shared memory.  uu: u8 x u8; su: s8 x u8; us: u8 x s8.
#define K1_WGMMA_FN(FN, N, TYPES, NR, REGS, ACC, IA, IB, IS)                                \
  static __device__ __forceinline__ void FN(int32_t(&d)[NR], uint64_t da, uint64_t db) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" N "k32.s32." TYPES " " REGS           \
                 ", %" IA ", %" IB ", p;\n}\n"                                              \
                 : ACC(d, 0)                                                                \
                 : "l"(da), "l"(db), "r"(1));                                               \
  }
#define K1_WGMMA(N, NR, REGS, ACC, IA, IB, IS)                   \
  template <>                                                    \
  struct Wgmma<NR> {                                             \
    K1_WGMMA_FN(uu, N, "u8.u8", NR, REGS, ACC, IA, IB, IS)       \
    K1_WGMMA_FN(su, N, "s8.u8", NR, REGS, ACC, IA, IB, IS)       \
    K1_WGMMA_FN(us, N, "u8.s8", NR, REGS, ACC, IA, IB, IS)       \
  };

template <int NR>
struct Wgmma;
K1_WGMMA("8", 4, K1_REGS4, K1_ACC4, "4", "5", "6")
K1_WGMMA("16", 8, K1_REGS8, K1_ACC8, "8", "9", "10")
K1_WGMMA("32", 16, K1_REGS16, K1_ACC16, "16", "17", "18")
K1_WGMMA("64", 32, K1_REGS32, K1_ACC32, "32", "33", "34")
K1_WGMMA("128", 64, K1_REGS64, K1_ACC64, "64", "65", "66")

// Byte f of four packed table entries (one per k), as one 4-byte word.
__device__ __forceinline__ uint32_t gather_byte(int f, uint2 e0, uint2 e1, uint2 e2, uint2 e3) {
  const uint32_t sel = (f & 3) | ((4 + (f & 3)) << 4);
  const uint32_t lo = __byte_perm(f < 4 ? e0.x : e0.y, f < 4 ? e1.x : e1.y, sel);
  const uint32_t hi = __byte_perm(f < 4 ? e2.x : e2.y, f < 4 ? e3.x : e3.y, sel);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ void store_out(int32_t* out, size_t idx, uint32_t v, bool accumulate) {
  if (accumulate)
    atomicAdd(reinterpret_cast<unsigned int*>(out) + idx, v);
  else
    out[idx] = static_cast<int32_t>(v);
}

// SWAP = false (M >= 64): wgmma rows are output rows; ROWS_A = 128, two
//   warpgroups of 64 rows, wgmma n = kBN.
// SWAP = true (M < 64): wgmma rows are output columns; each warpgroup takes
//   64 of the block's kBN columns, wgmma n = ROWS_A >= M.
// tabs: [0] activation side, entry a = (vt_0(a), ..., vt_{NF-1}(a)) bytes,
//       the first NU of them u8 and the rest s8;
//       [1] weight side, entry b = (b, u'_0(b), ..., u'_{NF-1}(b)).
template <bool SWAP, int ROWS_A, int NF, int NU>
__global__ void __launch_bounds__(kThreads, SWAP ? 2 : 1)
approx_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                     const uint8_t* __restrict__ tabs, int32_t* __restrict__ out, int M,
                     int N, int K, int ldb, int c,
                     int tiles_per_split, int accumulate) {
  constexpr int A_BYTES = ROWS_A * kBK;
  constexpr int B_BYTES = kBK * kBN;
  constexpr int NR = SWAP ? ROWS_A / 2 : kBN / 2;  // accumulator registers per thread
  // the activation table is replicated too where its tile is large
  constexpr int TAB_A_BYTES = SWAP ? 256 * 8 : kRepTabBytes;
  extern __shared__ __align__(128) uint8_t smem[];
  uint2* s_tab_b = reinterpret_cast<uint2*>(smem);
  uint2* s_tab_a = reinterpret_cast<uint2*>(smem + kRepTabBytes);
  uint8_t* ring = smem + kRepTabBytes + TAB_A_BYTES;
  uint8_t* mapped = ring + kStages * (A_BYTES + B_BYTES);
  constexpr int map_bytes = NF * A_BYTES + (1 + NF) * B_BYTES;
  auto raw_a = [&](int s) { return ring + s * (A_BYTES + B_BYTES); };
  auto raw_b = [&](int s) { return ring + s * (A_BYTES + B_BYTES) + A_BYTES; };
  auto map_a = [&](int buf, int f) { return mapped + buf * map_bytes + f * A_BYTES; };
  auto map_b = [&](int buf, int f) {
    return mapped + buf * map_bytes + NF * A_BYTES + f * B_BYTES;
  };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * kBN;
  const int m0 = SWAP ? 0 : blockIdx.y * ROWS_A;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int T = min(k_tiles, kt0 + tiles_per_split) - kt0;
  if (T <= 0) return;

  const int lane = tid & 31, rep_lane = tid & (kRep - 1);
  {
    const uint2* g_tab = reinterpret_cast<const uint2*>(tabs);
    for (int i = tid; i < 256 * kRep; i += kThreads) {
      s_tab_b[i] = g_tab[256 + i / kRep];
      if (!SWAP) s_tab_a[i] = g_tab[i / kRep];
    }
    if (SWAP) s_tab_a[tid] = g_tab[tid];
  }
  // entry `code`, from this lane's copy: a half-warp's 8-byte reads hit
  // 16 distinct bank pairs whatever the codes
  auto look_b = [&](uint32_t code) { return s_tab_b[code * kRep + rep_lane]; };
  auto look_a = [&](uint32_t code) { return SWAP ? s_tab_a[code] : s_tab_a[code * kRep + rep_lane]; };

  auto load_raw = [&](int t, int slot) {
    const int k0 = (kt0 + t) * kBK;
    if (tid < ROWS_A * 2) {  // chunk (row r, k-half kc) -> core-matrix slot tid * 16
      const int r = ((tid >> 4) << 3) | (tid & 7), kc = (tid >> 3) & 1;
      const int gm = m0 + r, gk = k0 + kc * 16;
      const bool ok = gm < M && gk < K;
      cp_async16(smem_u32(raw_a(slot)) + tid * 16, ok ? a + (size_t)gm * K + gk : a, ok);
    }
    {  // row kk of the weight tile, 16-byte chunk nc: [kBK][kBN], N contiguous
      const int kk = tid >> 3, nc = tid & 7;
      const int gk = k0 + kk, gn = n0 + nc * 16;
      const bool ok = gk < K && gn < N;
      cp_async16(smem_u32(raw_b(slot)) + tid * 16, ok ? b + (size_t)gk * ldb + gn : b, ok);
    }
  };

  auto map_tile = [&](int slot, int buf) {
    // activation side: the raw tile is in the operand layout already, so
    // each feature tile takes the same word offsets
    const uint32_t* ra = reinterpret_cast<const uint32_t*>(raw_a(slot));
    for (int w = tid; w < A_BYTES / 4; w += kThreads) {
      const uint32_t x = ra[w];
      const uint2 e0 = look_a(x & 255), e1 = look_a((x >> 8) & 255),
                  e2 = look_a((x >> 16) & 255), e3 = look_a(x >> 24);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        reinterpret_cast<uint32_t*>(map_a(buf, f))[w] = gather_byte(f, e0, e1, e2, e3);
    }
    // weight side: a 4 (k) x 4 (n) block per thread, transposed to K-major.
    // A store lands on bank 4*(n%8) + kq%4; a warp spans 4 values of kq%4
    // and 8 of nq%8, and step s of thread (kq, nq) takes column
    // (s + rot) % 4 of its block, so each store instruction hits 32 banks.
    const uint32_t* rb = reinterpret_cast<const uint32_t*>(raw_b(slot));
    const int warp = tid >> 5;
    const int kq = ((warp & 1) << 2) | (lane & 3);
    const int nq = ((warp >> 1) << 3) | (lane >> 2);
    const int rot = (nq >> 1) & 3;
    uint2 e[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = rb[(4 * kq + i) * (kBN / 4) + nq];
#pragma unroll
      for (int s = 0; s < 4; ++s) e[i][s] = look_b((x >> (8 * ((s + rot) & 3))) & 255);
    }
#pragma unroll
    for (int f = 0; f <= NF; ++f) {
      uint8_t* dst = map_b(buf, f);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int n = 4 * nq + ((s + rot) & 3);
        const int off = (n >> 3) * 256 + (kq >> 2) * 128 + (n & 7) * 16 + (kq & 3) * 4;
        *reinterpret_cast<uint32_t*>(dst + off) = gather_byte(f, e[0][s], e[1][s], e[2][s], e[3][s]);
      }
    }
  };

  int32_t acc_e[NR], acc_c[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc_e[i] = acc_c[i] = 0;

  auto mma_tile = [&](int slot, int buf) {
    wgmma_fence();
    if constexpr (!SWAP) {
      const uint32_t a_off = wg * 64 * kBK;
      Wgmma<NR>::uu(acc_e, desc(smem_u32(raw_a(slot)) + a_off), desc(smem_u32(map_b(buf, 0))));
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const uint64_t da = desc(smem_u32(map_a(buf, f)) + a_off);
        const uint64_t db = desc(smem_u32(map_b(buf, 1 + f)));
        if (f < NU)
          Wgmma<NR>::uu(acc_c, da, db);
        else
          Wgmma<NR>::su(acc_c, da, db);
      }
    } else {
      const uint32_t b_off = wg * 64 * kBK;
      Wgmma<NR>::uu(acc_e, desc(smem_u32(map_b(buf, 0)) + b_off), desc(smem_u32(raw_a(slot))));
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const uint64_t da = desc(smem_u32(map_b(buf, 1 + f)) + b_off);
        const uint64_t db = desc(smem_u32(map_a(buf, f)));
        if (f < NU)
          Wgmma<NR>::uu(acc_c, da, db);
        else
          Wgmma<NR>::us(acc_c, da, db);
      }
    }
    wgmma_commit();
  };

  // prologue: kStages - 1 tiles in flight (one commit group per tile, empty
  // groups past the end keep the count), then map tile 0
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load_raw(s, s);
    cp_async_commit();
  }
  cp_async_wait_stages();
  __syncthreads();
  map_tile(0, 0);
  fence_proxy_async();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // slot (t - 1) % kStages: its tile was mapped and multiplied last round
    if (t + kStages - 1 < T) load_raw(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    mma_tile(t % kStages, t & 1);
    if (t + 1 < T) {
      cp_async_wait_stages();  // tile t + 1 has landed (this thread's copies)
      __syncthreads();         // ... and every thread's
      map_tile((t + 1) % kStages, (t + 1) & 1);
      fence_proxy_async();     // generic-proxy writes -> visible to wgmma
    }
    wgmma_wait_all();
    fence_acc(acc_e);
    fence_acc(acc_c);
    __syncthreads();
  }

  // epilogue: acc_e - c * acc_c in two's-complement 32-bit arithmetic
  const int warp = (tid & 127) >> 5;
  const uint32_t cu = static_cast<uint32_t>(c);
  const bool acc = accumulate != 0;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const uint32_t v = static_cast<uint32_t>(acc_e[i]) - cu * static_cast<uint32_t>(acc_c[i]);
    // accumulator i of a thread: row 16*warp + lane/4 + 8*((i/2)&1), column
    // 8*(i/4) + 2*(lane%4) + (i&1) of the warpgroup's 64 x n tile
    const int r = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const int gm = SWAP ? col : m0 + wg * 64 + r;
    const int gn = SWAP ? n0 + wg * 64 + r : n0 + col;
    if (gm < M && gn < N) store_out(out, (size_t)gm * N + gn, v, acc);
  }
}

template <bool SWAP, int ROWS_A, int NF, int NU>
cudaError_t launch(const uint8_t* a, const uint8_t* b, const uint8_t* tabs, int32_t* out, int M,
                   int N, int K, int ldb, int c, cudaStream_t stream) {
  auto kernel = approx_matmul_kernel<SWAP, ROWS_A, NF, NU>;
  constexpr int smem = kRepTabBytes + (SWAP ? 256 * 8 : kRepTabBytes) +
                       kStages * (ROWS_A * kBK + kBK * kBN) +
                       2 * (NF * ROWS_A * kBK + (1 + NF) * kBK * kBN);
  // once per instantiation and device: the shared-memory limit, the SM
  // count and how many blocks an SM holds (a decode step makes 281 calls)
  static int cached_dev = -1, sms = 0, per_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cached_dev = dev;
  }
  const int gx = (N + kBN - 1) / kBN;
  const int gy = SWAP ? 1 : (M + ROWS_A - 1) / ROWS_A;
  const int k_tiles = (K + kBK - 1) / kBK;
  // split K until the tiles fill one wave of resident blocks
  int splits = (per_sm < 1 ? 1 : per_sm) * sms / (gx * gy);
  const int max_splits = k_tiles / kMinTilesPerSplit;
  splits = splits > max_splits ? max_splits : splits;
  splits = splits < 1 ? 1 : splits;
  const int tiles_per_split = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + tiles_per_split - 1) / tiles_per_split;
  if (splits > 1) {
    err = cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)M * N, stream);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(gx, gy, splits), kThreads, smem, stream>>>(
      a, b, tabs, out, M, N, K, ldb, c, tiles_per_split, splits > 1);
  return cudaGetLastError();
}

// one instantiation per (NF, NU): NF <= kMaxF features, NU <= 1 u8 maps
#define K1_CASE(NF_, NU_) \
  case 2 * NF_ + NU_:     \
    return launch<SWAP, ROWS_A, NF_, NU_>(a, b, tabs, out, M, N, K, ldb, c, stream);
template <bool SWAP, int ROWS_A>
cudaError_t dispatch(const uint8_t* a, const uint8_t* b, const uint8_t* tabs, int32_t* out,
                     int M, int N, int K, int ldb, int nf, int nu, int c, cudaStream_t stream) {
  switch (2 * nf + nu) {
    K1_CASE(0, 0)
    K1_CASE(1, 0) K1_CASE(1, 1) K1_CASE(2, 0) K1_CASE(2, 1) K1_CASE(3, 0) K1_CASE(3, 1)
    K1_CASE(4, 0) K1_CASE(4, 1) K1_CASE(5, 0) K1_CASE(5, 1) K1_CASE(6, 0) K1_CASE(6, 1)
    K1_CASE(7, 0) K1_CASE(7, 1)
  }
  return cudaErrorInvalidValue;
}
#undef K1_CASE

}  // namespace

// a: (M, K) uint8, rows K bytes apart; b: (K, N) uint8, rows ldb bytes
// apart; K and ldb multiples of 16 (zero-padded), both 16-byte aligned.
// tabs: (2, 256, 8) uint8 packed feature tables; nf features, the first
// nu of them u8 on the activation side (0 or 1), the rest s8; c the
// common factor.
// out: (M, N) int32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int approx_matmul_launch(const void* a, const void* b, const void* tabs, void* out,
                                    int M, int N, int K, int ldb, int nf, int nu, int c,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  if (K % 16 || ldb % 16 || ldb < N || nf < 0 || nf > kMaxF || nu < 0 || nu > 1 || nu > nf ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(tabs) % 16)
    return cudaErrorInvalidValue;
  auto* a8 = static_cast<const uint8_t*>(a);
  auto* b8 = static_cast<const uint8_t*>(b);
  auto* t8 = static_cast<const uint8_t*>(tabs);
  auto* o32 = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M >= 64) return dispatch<false, 128>(a8, b8, t8, o32, M, N, K, ldb, nf, nu, c, s);
  if (M <= 8) return dispatch<true, 8>(a8, b8, t8, o32, M, N, K, ldb, nf, nu, c, s);
  if (M <= 16) return dispatch<true, 16>(a8, b8, t8, o32, M, N, K, ldb, nf, nu, c, s);
  if (M <= 32) return dispatch<true, 32>(a8, b8, t8, o32, M, N, K, ldb, nf, nu, c, s);
  return dispatch<true, 64>(a8, b8, t8, o32, M, N, K, ldb, nf, nu, c, s);
}
