"""The card's TF32 rate through mma.sync, the instruction of PTX's warp-level
matrix products, against the data sheet's 495 TFLOP/s (reached only by
wgmma).  It is why the fused PointNet kernel (vlsat_tpu_torch/csrc/
pointnet.cu) runs its largest product with wgmma.

    python tools/torch_mma_probe.py

Needs an NVIDIA Hopper card and nvcc; builds into vlsat_tpu_torch/_build/.
Prints one JSON line per launch shape and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from vlsat_tpu_torch.ops.kernels import build  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
// 16 independent m16n8k8 TF32 products per step on register operands.
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b[2] = {threadIdx.x * 5u, 11u};
  float c[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
  for (int j = 0; j < 16; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float mma_loop_ms(int blocks, int threads, int iters, float* out) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.0f;
  for (int rep = 0; rep < 2; ++rep) {  // the first launch warms up
    cudaEventRecord(e0);
    mma_loop<<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.0f;
}
"""


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "mma_probe.cu"
    lib_path = build.BUILD_DIR / "libmma_probe.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_loop_ms.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mma_loop_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 512, device="cuda")
    iters = 4096
    for blocks_per_sm, threads in ((1, 128), (1, 256), (2, 256), (4, 256), (1, 512)):
        ms = lib.mma_loop_ms(sms * blocks_per_sm, threads, iters, out.data_ptr())
        if ms <= 0:
            raise SystemExit("the probe kernel failed")
        flops = sms * blocks_per_sm * (threads // 32) * iters * 16 * 2 * 16 * 8 * 8
        print(json.dumps({"mma_sync_tf32": {"blocks_per_sm": blocks_per_sm, "threads": threads,
                                            "ms": ms, "tflops": flops / ms / 1e9}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
