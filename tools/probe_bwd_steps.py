#!/usr/bin/env python3
"""Phase stamps of the LSTM and GRU backward's serial kernel
(``bwd_cluster_kernel`` in ``ctc_pytorch_tpu_torch/csrc/bwd_hoist.cuh``) on
one GPU: the cycles a step spends in each phase, at the bench and recipe
shapes with bf16 streams, and the clusters the card holds at once.

    python3 tools/probe_bwd_steps.py

Builds the header with ``BWD_STEP_STAMPS`` defined (thread 0 of the first
CTA adds ``clock64()`` deltas between the kernel's phases) and the small main
below into the git-ignored ``csrc/build/probes/`` with nvcc for sm_90a, and
runs it.  The stamps cost cycles of their own; the package's build leaves
them out.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ctc_pytorch_tpu_torch.ops._build import BUILD_DIR, CSRC, nvcc  # noqa: E402

PHASES = ["wait for the data", "receive sum", "read arrive", "element-wise",
          "loads issued", "CTA barrier", "product", "wait for the reads",
          "DSMEM stores", "data arrive", "global stores"]

MAIN = r"""
#include "bwd_hoist.cuh"
#include <cstdio>

template <class Cell>
void run(int T, int B, int H, const char* what) {
  const int P = Cell::kPlanes, G = Cell::kGates, ndir = 2;
  const int Hp = (H + 3) / 4 * 4;
  const size_t n_planes = (size_t)ndir * T * P * B * Hp;
  const size_t n_w = (size_t)ndir * H * G * H, n_y = (size_t)T * B * ndir * H;
  float *planes, *w;
  __nv_bfloat16 *dy, *dgx, *dhhn;
  cudaMalloc(&planes, n_planes * 4);
  cudaMalloc(&w, n_w * 4);
  cudaMalloc(&dy, n_y * 2);
  cudaMalloc(&dgx, n_y * G * 2);
  cudaMalloc(&dhhn, n_y * 2);
  cudaMemset(planes, 0, n_planes * 4);
  cudaMemset(w, 0, n_w * 4);
  cudaMemset(dy, 0, n_y * 2);
  int branch = 0, cap = 0;
  cluster_branch<Cell>(B, H, ndir, 1, &branch);
  cluster_capacity<Cell, 1>(cluster_shape(G, H, 1), B, ndir, &cap);
  if (branch == 0) {
    printf("%s: grid branch, no stamps\n", what);
    return;
  }
  for (int rep = 0; rep < 2; ++rep) {
    long long zero[16] = {0};
    cudaMemcpyToSymbol(bwd_step_cycles, zero, sizeof(zero));
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    const cudaError_t err =
        branch == 2 ? launch_cluster<Cell, 2>(planes, w, dy, dgx, dhhn, T, B, H,
                                              Hp, ndir, 0)
                    : launch_cluster<Cell, 1>(planes, w, dy, dgx, dhhn, T, B, H,
                                              Hp, ndir, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    long long acc[16];
    cudaMemcpyFromSymbol(acc, bwd_step_cycles, sizeof(acc));
    long long total = 0;
    printf("%s: %d-row clusters (16-row clusters held at once: %d), %.4f ms, "
           "%.2f us a step; cycles a step by phase:",
           what, 16 * branch, cap, ms, 1e3 * ms / T);
    for (int i = 0; i < 11; ++i) {
      printf(" %lld", acc[i] / (T - 1));
      total += acc[i];
    }
    printf(" | total %lld (%s)\n", total / (T - 1),
           cudaGetErrorString(err != cudaSuccess ? err : cudaGetLastError()));
  }
}

int main() {
  int clock_khz = 0;
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  printf("SM clock %d kHz\n", clock_khz);
  run<LstmCell>(80, 16, 384, "lstm T=80 B=16 H=384");
  run<LstmCell>(80, 128, 384, "lstm T=80 B=128 H=384");
  run<GruCell>(95, 16, 256, "gru T=95 B=16 H=256");
  run<GruCell>(95, 128, 256, "gru T=95 B=128 H=256");
  return 0;
}
"""


def main() -> int:
    out = BUILD_DIR / "probes"
    out.mkdir(parents=True, exist_ok=True)
    cu, exe = out / "step_stamps.cu", out / "step_stamps"
    cu.write_text(MAIN)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-DBWD_STEP_STAMPS", f"-I{CSRC}", "-o",
                    str(exe), str(cu)], check=True)
    print("phases:", ", ".join(PHASES))
    subprocess.run([str(exe)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
