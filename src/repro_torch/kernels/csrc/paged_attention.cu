// K2: one GQA decode step over the paged KV pool, through the block table.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel_call`
// (src/repro/kernels/paged_attention/kernel.py, body `_kernel`), whose grid
// walks (row, table entry) in order and carries the online softmax in VMEM
// scratch across the walk.
//
// Here one thread block owns one (row b, KV head h) pair and walks row b's
// table itself: table entries >= num_blocks (the sentinel) and blocks whose
// first position is past cur_len[b] are skipped, so only blocks the row
// really holds are read.  Each block's (block_size, hd) K/V slice for head
// h is staged in shared memory in f32; the new token's K/V (already cast to
// the pool dtype by the caller) takes the place of row cur_len % block_size
// of block cur_len / block_size while staging, so the kernel reads the
// pool as it was before this step's write.  One warp per query head of the
// group (H / Hkv heads share KV head h) keeps a running max, normaliser and
// accumulator in f32; a row with no valid block writes exact 0.
//
// What bounds it on an H100: the bytes of the K/V blocks a row holds (one
// read of each, f32), far below the compute rate — decode attention is
// memory-bound.  What the design does about it: it reads each held block
// once per KV head and skips sentinel and past-length blocks entirely.
// Grid (B, Hkv) gives few blocks at small batch; splitting a row's walk
// across blocks (flash-decoding) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDimsPerLane = 4;  // head_dim <= 128
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void paged_attention_kernel(
    const float* __restrict__ q,         // (B, H, hd)
    const float* __restrict__ k_new,     // (B, Hkv, hd)
    const float* __restrict__ v_new,     // (B, Hkv, hd)
    const float* __restrict__ k_pool,    // (num_blocks, bs, Hkv, hd)
    const float* __restrict__ v_pool,
    const int32_t* __restrict__ table,   // (B, W)
    const int32_t* __restrict__ cur_len, // (B,)
    float* __restrict__ out,             // (B, H, hd)
    int H, int Hkv, int hd, int bs, int W, int num_blocks) {
  extern __shared__ float smem[];
  const int g = H / Hkv;
  float* ks = smem;                 // [bs][hd]
  float* vs = ks + bs * hd;         // [bs][hd]
  float* sc = vs + bs * hd;         // [g][bs] scores of the current block

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;   // query head within the group
  const int head = h * g + warp;
  const int cur = cur_len[b];
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  float qreg[kMaxDimsPerLane], acc[kMaxDimsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) {
    const int d = lane + 32 * i;
    qreg[i] = d < hd ? q[((size_t)b * H + head) * hd + d] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;
  float* my_sc = sc + warp * bs;
  const int cur_blk = cur / bs, cur_off = cur % bs;
  const size_t new_base = ((size_t)b * Hkv + h) * hd;

  for (int w = 0; w < W; ++w) {
    const int entry = table[(size_t)b * W + w];
    if (entry < 0 || entry >= num_blocks || w * bs > cur) continue;  // uniform per block
    __syncthreads();  // previous block's tiles fully consumed
    for (int i = threadIdx.x; i < bs * hd; i += blockDim.x) {
      const int t = i / hd, d = i % hd;
      if (w == cur_blk && t == cur_off) {
        ks[i] = k_new[new_base + d];
        vs[i] = v_new[new_base + d];
      } else {
        const size_t off = (((size_t)entry * bs + t) * Hkv + h) * hd + d;
        ks[i] = k_pool[off];
        vs[i] = v_pool[off];
      }
    }
    __syncthreads();

    const int nvalid = min(bs, cur - w * bs + 1);
    float bmax = kNeg;
    for (int t = 0; t < nvalid; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part += qreg[i] * ks[t * hd + d];
      }
      const float s = warp_sum(part);
      if (lane == 0) my_sc[t] = s;
      bmax = fmaxf(bmax, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, bmax);
    const float alpha = expf(m - m_new);
    float lsum = 0.f;
    float pv[kMaxDimsPerLane] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < nvalid; ++t) {
      const float p = expf(my_sc[t] - m_new);
      lsum += p;
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) pv[i] += p * vs[t * hd + d];
      }
    }
    l = l * alpha + lsum;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[i] = acc[i] * alpha + pv[i];
    m = m_new;
    __syncwarp();  // my_sc reused by the next block
  }

#pragma unroll
  for (int i = 0; i < kMaxDimsPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) out[((size_t)b * H + head) * hd + d] = l > 0.f ? acc[i] / l : 0.f;
  }
}

}  // namespace

// All tensors contiguous f32 (table/cur_len int32).  The caller has checked
// H % Hkv == 0, H / Hkv <= 32, hd <= 128 and the shared-memory size.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* table, const void* cur_len, void* out,
    int B, int H, int Hkv, int hd, int bs, int W, int num_blocks, void* stream) {
  if (B <= 0) return 0;
  const int g = H / Hkv;
  const size_t smem = (size_t)(2 * bs * hd + g * bs) * sizeof(float);
  dim3 grid(B, Hkv);
  paged_attention_kernel<<<grid, 32 * g, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_new),
      static_cast<const float*>(v_new), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(cur_len), static_cast<float*>(out),
      H, Hkv, hd, bs, W, num_blocks);
  return cudaGetLastError();
}
