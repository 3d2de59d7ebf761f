// K2: one GQA decode step over the paged KV pool, through the block table.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel_call`
// (src/repro/kernels/paged_attention/kernel.py, body `_kernel`), whose grid
// walks (row, table entry) in order and carries the online softmax in VMEM
// scratch across the walk.  As there, the pool may be f32 or bf16 and is
// read in its stored dtype and upcast to f32 in registers; q is f32 or bf16
// and the output is written in q's dtype (bf16 rounded to nearest even).
//
// What bounds it on an H100: the bytes of the K/V blocks a row holds (one
// read of each, 2 * bs * hd * sizeof(pool) per held block and KV head), far
// below the compute rate: decode attention is memory-bound, and a bf16 pool
// halves those bytes.  What the design does about it:
//
// * Split table walk (flash-decoding).  The grid is (splits, Hkv, B): one
//   thread block owns one row, one KV head and one contiguous chunk of
//   `chunk` table entries, so a small batch still puts hundreds of blocks
//   on the 132 SMs.  The wrapper picks `chunk` from B * Hkv and W alone; it
//   never reads the table or cur_len on the host.  Sentinel entries
//   (>= num_blocks) and blocks whose first position is past cur_len are
//   dropped while the chunk's entries are compacted (one warp, ballot), and
//   a chunk with no valid position writes l = 0 and does no other work.
// * Copies up front.  Every held block's K and V rows go to shared memory
//   by cp.async (16-byte copies, 8 where a bf16 row is not a multiple of
//   16 bytes), `rounds` of R blocks at a time into a ring of two rounds, so
//   a block pays DRAM latency once per chunk (once per round beyond two
//   rounds) rather than once per block.  Only the rows up to cur_len are
//   copied; the new token's K/V row (already in the pool dtype) is copied
//   from k_new/v_new in place of row cur_len % bs of block cur_len / bs, so
//   the pool is read as it was before this step's write.  Rows are padded
//   by one copy unit, so the 32 lanes of a warp, which read 32 different
//   positions at one dimension, hit different banks.
// * The g query heads of the KV group are computed together over the
//   round's positions: one thread per (head, position) for the scores, a
//   warp per head for the softmax stats (max and sum by shuffles, once per
//   round, not per position), and one thread per (head, four dimensions)
//   for P @ V, with the running max, sum and accumulator of each head in
//   shared memory.  Positions past cur_len are never scored, so their
//   weight is exactly 0.
// * Split merge in the same launch.  Each block writes its partial
//   (m, l, acc) to scratch, then takes a ticket from a per-(row, KV head)
//   counter; the last block to finish merges out = sum e^{m_s-M} acc_s /
//   sum e^{m_s-M} l_s over the splits with l_s > 0 and resets the counter
//   to 0 for the next call.  A row with no valid position writes exact 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int kVec>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kVec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// kVec bytes of the pool dtype from shared memory -> floats
template <typename T, int kVec> struct Unit;
template <> struct Unit<float, 16> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const char* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Unit<__nv_bfloat16, 16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const char* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = x.x; f[2 * i + 1] = x.y;
    }
  }
};
template <> struct Unit<__nv_bfloat16, 8> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const char* p, float* f) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = x.x; f[2 * i + 1] = x.y;
    }
  }
};

struct Params {
  const void* q;          // (B, H, hd) TQ
  const void* k_new;      // (B, Hkv, hd) TKV
  const void* v_new;
  const void* k_pool;     // (num_blocks, bs, Hkv, hd) TKV
  const void* v_pool;
  const int32_t* table;   // (B, W)
  const int32_t* cur_len; // (B,)
  void* out;              // (B, H, hd) TQ
  float* part;            // scratch: m, l (B*Hkv*splits*g each), acc (... * hd)
  int32_t* counters;      // (B * Hkv) tickets, 0 between calls
  int H, Hkv, hd, bs, W, num_blocks;
  int splits, chunk, R, nslot;
};

// Shared-memory layout, each region on a 16-byte boundary; the wrapper's
// `_smem_bytes` is the same sum.
struct Layout {
  int stride;             // bytes per staged row: one copy unit of padding
  size_t kring, vring, q, acc, sc, st, mrg, ent, pos, misc, total;
  __host__ __device__ static size_t up16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }
  __host__ __device__ Layout(int g, int hd, int bs, int esize, int vec, int R, int nslot,
                             int splits, int chunk) {
    stride = hd * esize + vec;
    kring = 0;
    vring = up16(kring + (size_t)nslot * bs * stride);
    q = up16(vring + (size_t)nslot * bs * stride);
    acc = up16(q + (size_t)g * hd * 4);
    sc = up16(acc + (size_t)g * hd * 4);
    st = up16(sc + (size_t)g * R * bs * 4);
    mrg = up16(st + (size_t)3 * g * 4);
    ent = up16(mrg + (size_t)(2 * splits + 1) * g * 4);
    pos = up16(ent + (size_t)chunk * 4);
    misc = up16(pos + (size_t)chunk * 4);
    total = misc + 16;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four consecutive elements of a staged row -> floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename TQ, typename TKV, int kVec>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int g = p.H / p.Hkv, hd = p.hd, bs = p.bs;
  constexpr int esize = sizeof(TKV);
  const Layout lay(g, hd, bs, esize, kVec, p.R, p.nslot, p.splits, p.chunk);
  const int stride = lay.stride;
  char* kring = smem + lay.kring;
  char* vring = smem + lay.vring;
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* m_s = reinterpret_cast<float*>(smem + lay.st);
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;
  int* ent_s = reinterpret_cast<int*>(smem + lay.ent);
  int* pos_s = reinterpret_cast<int*>(smem + lay.pos);   // table index w of each held block
  int* misc = reinterpret_cast<int*>(smem + lay.misc);

  const int pair = b * p.Hkv + h;
  const int w0 = s * p.chunk;
  const int w1 = min(p.W, w0 + p.chunk);
  const int cur = p.cur_len[b];

  if (warp == 0) {
    // compact this chunk's held blocks: allocated and first position <= cur
    int n = 0;
    for (int base = w0; base < w1; base += 32) {
      const int w = base + lane;
      const int e = w < w1 ? p.table[(size_t)b * p.W + w] : -1;
      const bool ok = e >= 0 && e < p.num_blocks && w * bs <= cur;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int at = n + __popc(m & ((1u << lane) - 1u));
        ent_s[at] = e;
        pos_s[at] = w;
      }
      n += __popc(m);
    }
    if (lane == 0) misc[0] = n;
  } else {
    // meanwhile the other warps stage the group's scaled queries
    const float scale = 1.0f / sqrtf(static_cast<float>(hd));
    const TQ* q = static_cast<const TQ*>(p.q) + ((size_t)b * p.H + (size_t)h * g) * hd;
    for (int i = tid - 32; i < g * hd; i += kThreads - 32) {
      q_s[i] = to_f32(q[i]) * scale;
      acc_s[i] = 0.f;
    }
  }
  if (tid < g) { m_s[tid] = kNeg; l_s[tid] = 0.f; }
  const size_t np = (size_t)gridDim.z * p.Hkv * p.splits * g;    // partials per stat
  const size_t slot0 = ((size_t)pair * p.splits + s) * g;
  float* pm = p.part;
  float* pl = p.part + np;
  float* pacc = p.part + 2 * np;
  __syncthreads();
  const int nv = misc[0];

  if (nv > 0) {
    const int cur_blk = cur / bs, cur_off = cur % bs;
    const int R = p.R;
    const int rounds = (nv + R - 1) / R;
    const int units = hd * esize / kVec;           // copy units per row
    const size_t row_bytes = (size_t)hd * esize;
    const char* kpool = static_cast<const char*>(p.k_pool);
    const char* vpool = static_cast<const char*>(p.v_pool);
    const char* knew = static_cast<const char*>(p.k_new) + ((size_t)b * p.Hkv + h) * row_bytes;
    const char* vnew = static_cast<const char*>(p.v_new) + ((size_t)b * p.Hkv + h) * row_bytes;
    // valid positions of round r: a prefix of its rows (only the last held
    // block can end before its last row)
    auto valid_rows = [&](int r) {
      const int j1 = min(nv, (r + 1) * R) - 1;
      return (j1 - r * R) * bs + min(bs, cur - pos_s[j1] * bs + 1);
    };

    // copy round r's valid rows into ring half r & 1 (rows contiguous by
    // position); where the units of a row divide the block's threads, each
    // thread keeps one unit column and walks the rows without dividing
    auto copy_row_unit = [&](int r, int ru, int jj, int t, int c) {
      const int j = r * R + jj;
      const char *ks, *vs;
      if (pos_s[j] == cur_blk && t == cur_off) {
        ks = knew;
        vs = vnew;
      } else {
        const size_t off = (((size_t)ent_s[j] * bs + t) * p.Hkv + h) * row_bytes;
        ks = kpool + off;
        vs = vpool + off;
      }
      const size_t dst = (size_t)((r & 1) * R * bs + ru) * stride + c * kVec;
      cp_async<kVec>(kring + dst, ks + c * kVec);
      cp_async<kVec>(vring + dst, vs + c * kVec);
    };
    auto issue = [&](int r) {
      if (r < rounds) {
        const int rows = valid_rows(r);
        if (kThreads % units == 0) {
          const int c = tid % units, dr = kThreads / units;
          int ru = tid / units, jj = ru / bs, t = ru - jj * bs;
          for (; ru < rows; ru += dr) {
            copy_row_unit(r, ru, jj, t, c);
            for (t += dr; t >= bs; t -= bs) ++jj;
          }
        } else {
          for (int i = tid; i < rows * units; i += kThreads) {
            const int ru = i / units, jj = ru / bs;
            copy_row_unit(r, ru, jj, ru - jj * bs, i - ru * units);
          }
        }
      }
      cp_async_commit();                             // one group per round, even if empty
    };
    issue(0);
    issue(1);

    using U = Unit<TKV, kVec>;
    const int RB = R * bs;
    for (int r = 0; r < rounds; ++r) {
      cp_async_wait_all_but_one();
      __syncthreads();
      const int U_r = valid_rows(r);
      const char* krows = kring + (size_t)((r & 1) * RB) * stride;
      const char* vrows = vring + (size_t)((r & 1) * RB) * stride;

      // scores: one thread per (head, position), q read as float4 (broadcast)
      {
        int gi = tid / U_r, u = tid - gi * U_r;
        const int dgi = kThreads / U_r, du = kThreads - dgi * U_r;
        for (; gi < g; gi += dgi, u += du) {
          if (u >= U_r) { u -= U_r; ++gi; if (gi >= g) break; }
          const char* krow = krows + (size_t)u * stride;
          const float* qrow = q_s + gi * hd;
          float a0 = 0.f, a1 = 0.f;
          for (int c = 0; c < units; ++c) {
            float kf[U::kN];
            U::load(krow + c * kVec, kf);
#pragma unroll
            for (int e = 0; e < U::kN; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qrow + c * U::kN + e);
              a0 = fmaf(qv.x, kf[e], a0);
              a1 = fmaf(qv.y, kf[e + 1], a1);
              a0 = fmaf(qv.z, kf[e + 2], a0);
              a1 = fmaf(qv.w, kf[e + 3], a1);
            }
          }
          sc[gi * RB + u] = a0 + a1;
        }
      }
      __syncthreads();

      // softmax stats: one warp per head; scores become probabilities in place
      for (int gi = warp; gi < g; gi += kWarps) {
        float* row = sc + gi * RB;
        float mx = kNeg;
        for (int u = lane; u < U_r; u += 32) mx = fmaxf(mx, row[u]);
        const float m_old = m_s[gi];
        const float m_new = fmaxf(m_old, warp_max(mx));
        float ls = 0.f;
        for (int u = lane; u < U_r; u += 32) {
          const float pu = expf(row[u] - m_new);
          row[u] = pu;
          ls += pu;
        }
        ls = warp_sum(ls);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          alpha_s[gi] = alpha;
          l_s[gi] = l_s[gi] * alpha + ls;
          m_s[gi] = m_new;
        }
      }
      __syncthreads();

      // P @ V: one thread per (head, four dimensions)
      for (int i = tid; i < g * hd / 4; i += kThreads) {
        const int gi = (4 * i) / hd, d = 4 * i - gi * hd;
        const float* prow = sc + gi * RB;
        const char* vcol = vrows + (size_t)d * esize;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int u = 0; u < U_r; ++u) {
          const float pu = prow[u];
          const float4 v = load4(reinterpret_cast<const TKV*>(vcol + (size_t)u * stride));
          a.x = fmaf(pu, v.x, a.x);
          a.y = fmaf(pu, v.y, a.y);
          a.z = fmaf(pu, v.z, a.z);
          a.w = fmaf(pu, v.w, a.w);
        }
        const float alpha = alpha_s[gi];
        float4* acc = reinterpret_cast<float4*>(acc_s + 4 * i);
        const float4 o = *acc;
        *acc = make_float4(o.x * alpha + a.x, o.y * alpha + a.y, o.z * alpha + a.z,
                           o.w * alpha + a.w);
      }
      __syncthreads();                               // ring half and scores free
      issue(r + 2);
    }
  } else {
    for (int i = tid; i < g * hd; i += kThreads) acc_s[i] = 0.f;
    __syncthreads();
  }
  for (int i = tid; i < g * hd; i += kThreads) pacc[slot0 * hd + i] = acc_s[i];
  if (tid < g) { pm[slot0 + tid] = m_s[tid]; pl[slot0 + tid] = l_s[tid]; }

  // the last block of this (row, KV head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(p.counters + pair, 1);
    const int last = ticket == p.splits - 1;
    if (last) p.counters[pair] = 0;
    misc[1] = last;
  }
  __syncthreads();
  if (!misc[1]) return;
  __threadfence();

  const int S = p.splits;
  float* wts = reinterpret_cast<float*>(smem + lay.mrg);   // (S, g): l, then the weight
  float* mm = wts + (size_t)S * g;                          // (S, g): m
  float* den = mm + (size_t)S * g;                          // (g)
  const size_t first = (size_t)pair * S * g;
  for (int i = tid; i < S * g; i += kThreads) {
    wts[i] = __ldcg(pl + first + i);
    mm[i] = __ldcg(pm + first + i);
  }
  __syncthreads();
  for (int gi = warp; gi < g; gi += kWarps) {
    float M = kNeg;
    for (int k = lane; k < S; k += 32)
      if (wts[k * g + gi] > 0.f) M = fmaxf(M, mm[k * g + gi]);
    M = warp_max(M);
    float dsum = 0.f;
    for (int k = lane; k < S; k += 32) {
      const float l = wts[k * g + gi];
      const float w = l > 0.f ? expf(mm[k * g + gi] - M) : 0.f;
      wts[k * g + gi] = w;
      dsum += w * l;
    }
    dsum = warp_sum(dsum);
    if (lane == 0) den[gi] = dsum;
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(p.out) + ((size_t)b * p.H + (size_t)h * g) * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    const int gi = i / hd;
    float num = 0.f;
#pragma unroll 4
    for (int k = 0; k < S; ++k)
      num = fmaf(wts[k * g + gi], __ldcg(pacc + (first + (size_t)k * g) * hd + i), num);
    const float dv = den[gi];
    from_f32(out + i, dv > 0.f ? num / dv : 0.f);
  }
}

template <typename TQ, typename TKV, int kVec>
int launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
  auto* fn = paged_attention_kernel<TQ, TKV, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fn<<<dim3(p.splits, p.Hkv, B), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out: f32 (q_bf16 = 0) or bf16 (1); pools and k_new/v_new: f32 (kv_bf16
// = 0) or bf16 (1); table/cur_len int32; part: f32 scratch of
// B*Hkv*splits*g*(hd+2); counters: B*Hkv int32 zeros.  All contiguous, the
// K/V operands aligned to `vec` (16, or 8 for a bf16 row that is not a
// multiple of 16 bytes).  The caller has checked the shapes and picked
// splits/chunk/R/nslot.  Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* table, const void* cur_len, void* out, void* part,
    void* counters, int B, int H, int Hkv, int hd, int bs, int W, int num_blocks,
    int splits, int chunk, int R, int nslot, int q_bf16, int kv_bf16, int vec, void* stream) {
  if (B <= 0) return 0;
  Params p{q, k_new, v_new, k_pool, v_pool, static_cast<const int32_t*>(table),
           static_cast<const int32_t*>(cur_len), out, static_cast<float*>(part),
           static_cast<int32_t*>(counters), H, Hkv, hd, bs, W, num_blocks,
           splits, chunk, R, nslot};
  const int esize = kv_bf16 ? 2 : 4;
  if ((hd * esize) % vec || (vec != 16 && vec != 8) || (!kv_bf16 && vec != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(H / Hkv, hd, bs, esize, vec, R, nslot, splits, chunk).total;
  auto st = static_cast<cudaStream_t>(stream);
  if (!kv_bf16)
    return q_bf16 ? launch<__nv_bfloat16, float, 16>(p, B, smem, st)
                  : launch<float, float, 16>(p, B, smem, st);
  if (vec == 16)
    return q_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, 16>(p, B, smem, st)
                  : launch<float, __nv_bfloat16, 16>(p, B, smem, st);
  return q_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, 8>(p, B, smem, st)
                : launch<float, __nv_bfloat16, 8>(p, B, smem, st);
}
