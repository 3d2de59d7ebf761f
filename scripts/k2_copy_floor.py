#!/usr/bin/env python3
"""What K2's bytes alone cost on the card: copy kernels that move the same
K/V rows into shared memory as the paged decode-attention kernel does, and
compute nothing.

    python3 scripts/k2_copy_floor.py [--out floor.json]

At granite-3-2b's long-context shape (4 rows of 4,096 positions, blocks
of 16, 8 KV heads of 64, four pools so that no call finds its blocks in
L2), for float32 and bfloat16 pools, CUDA-event ms per call of:

* ``per_head``: K2's own pattern: a block per (split of 16 table entries,
  KV head, row), one 64-element row per position and head, by 16-byte
  ``cp.async`` into a ring of two rounds of 3 blocks;
* ``all_heads``: a block per (split, row) copying whole pool blocks
  (every head of a position is contiguous), the best layout-given case;
* ``torch.add(pool, 0)``: a PyTorch elementwise pass over the K pool
  (reads and writes it once: twice the bytes of one pool read).

The gap between K2 and ``per_head`` is K2's compute not hidden behind its
copies.  Needs the card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

SRC = r'''
#include <cuda_runtime.h>
__device__ __forceinline__ void cpa(void* smem, const void* g) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(g));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }
// pool (nb, 16, 8, hd) with rows of `row` bytes; block (split, h, b)
__global__ void per_head(const char* kp, const char* vp, const int* tbl, int W, int chunk,
                         int R, int row, float* sink) {
  extern __shared__ __align__(16) char sm[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int rounds = (chunk + R - 1) / R, units = row / 16, stride = row + 16;
  auto issue = [&](int r) {
    if (r < rounds) {
      const int nbk = min(chunk, (r + 1) * R) - r * R;
      for (int i = tid; i < nbk * 16 * units; i += 128) {
        const int jj = i / (16 * units), t = (i / units) % 16, c = i % units;
        const int e = tbl[b * W + s * chunk + r * R + jj];
        const size_t off = (((size_t)e * 16 + t) * 8 + h) * row;
        const size_t dst = ((size_t)((r & 1) * R + jj) * 16 + t) * stride + c * 16;
        cpa(sm + dst, kp + off + c * 16);
        cpa(sm + 2 * R * 16 * stride + dst, vp + off + c * 16);
      }
    }
    commit();
  };
  issue(0);
  issue(1);
  float acc = 0.f;
  for (int r = 0; r < rounds; ++r) {
    wait1();
    __syncthreads();
    acc += reinterpret_cast<float*>(sm)[tid];
    __syncthreads();
    issue(r + 2);
  }
  if (acc == 12345.f) sink[0] = acc;
}
// block (split, b): whole pool blocks of `blk` contiguous bytes, one at a time
__global__ void all_heads(const char* kp, const char* vp, const int* tbl, int W, int chunk,
                          int blk, float* sink) {
  extern __shared__ __align__(16) char sm[];
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  float acc = 0.f;
  for (int j = 0; j < chunk; ++j) {
    const size_t e = tbl[b * W + s * chunk + j];
    for (int i = tid; i < blk / 16; i += 256) {
      cpa(sm + i * 16, kp + e * blk + i * 16);
      cpa(sm + blk + i * 16, vp + e * blk + i * 16);
    }
    commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    acc += reinterpret_cast<float*>(sm)[tid];
    __syncthreads();
  }
  if (acc == 12345.f) sink[0] = acc;
}
extern "C" int run_per_head(const void* kp, const void* vp, const void* tbl, int B, int W,
                            int splits, int chunk, int R, int row, void* sink, void* st) {
  const size_t smem = (size_t)2 * 2 * R * 16 * (row + 16);
  cudaFuncSetAttribute(per_head, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  per_head<<<dim3(splits, 8, B), 128, smem, (cudaStream_t)st>>>(
      (const char*)kp, (const char*)vp, (const int*)tbl, W, chunk, R, row, (float*)sink);
  return cudaGetLastError();
}
extern "C" int run_all_heads(const void* kp, const void* vp, const void* tbl, int B, int W,
                             int splits, int chunk, int blk, void* sink, void* st) {
  const size_t smem = (size_t)2 * blk;
  cudaFuncSetAttribute(all_heads, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  all_heads<<<dim3(splits, B), 256, smem, (cudaStream_t)st>>>(
      (const char*)kp, (const char*)vp, (const int*)tbl, W, chunk, blk, (float*)sink);
  return cudaGetLastError();
}
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_copy_floor: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels._build import ARCH_FLAGS, _nvcc

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = Path(tmp) / "floor.cu", Path(tmp) / "libfloor.so"
        src.write_text(SRC)
        subprocess.run([_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-o", str(lib), str(src)], check=True)
        so = ctypes.CDLL(str(lib))
    so.run_per_head.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    so.run_all_heads.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    cs.warm_up(dev)
    B, W, L, hd = 4, 256, 4, 64
    nb = B * W
    tbl = torch.as_tensor(np.random.default_rng(0).permutation(nb).reshape(B, W).astype(np.int32),
                          device=dev)
    sink = torch.zeros(4, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    report = {"card": smi}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        kp = torch.randn(L, nb, 16, 8, hd, device=dev).to(dt)
        vp = torch.randn(L, nb, 16, 8, hd, device=dev).to(dt)
        row = hd * kp.element_size()
        st = torch.cuda.current_stream().cuda_stream

        def per_head():
            for i in range(L):
                if so.run_per_head(kp[i].data_ptr(), vp[i].data_ptr(), tbl.data_ptr(), B, W, 16,
                                   16, 3, row, sink.data_ptr(), st):
                    raise RuntimeError("per_head launch failed")

        def all_heads():
            for i in range(L):
                if so.run_all_heads(kp[i].data_ptr(), vp[i].data_ptr(), tbl.data_ptr(), B, W,
                                    64, 4, 16 * 8 * row, sink.data_ptr(), st):
                    raise RuntimeError("all_heads launch failed")

        report[name] = {"pool_read_bytes_per_call": 2 * nb * 16 * 8 * row,
                        "per_head_ms": cs.cuda_ms(per_head) / L,
                        "all_heads_ms": cs.cuda_ms(all_heads) / L,
                        "torch_add_k_pool_ms": cs.cuda_ms(
                            lambda: [torch.add(kp[i], 0) for i in range(L)]) / L}
        report[name]["per_head_tb_per_s"] = (report[name]["pool_read_bytes_per_call"]
                                             / (report[name]["per_head_ms"] * 1e-3) / 1e12)
        print(name, json.dumps(report[name]), flush=True)
        del kp, vp
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
