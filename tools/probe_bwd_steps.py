#!/usr/bin/env python3
"""Phase stamps of the recurrences' cluster kernels on one GPU: the LSTM's
and GRU's backward serial kernel (``bwd_cluster_kernel`` in
``ctc_pytorch_tpu_torch/csrc/bwd_hoist.cuh``) at the bench and recipe shapes
with bf16 streams, the LSTM's on fp32 streams (``bwd_fma_kernel``, same
header) at the recipes' batches of 8 and 4 and the GRU's at B = 8, the wide
backward (``bwd_wide_kernel`` in ``csrc/bwd_wide.cuh``) at the fp32 bench
shapes and the LSTM's grid backward (``lstm_bidir_bwd_kernel`` in
``csrc/lstm_bidir_train.cu``) beside it, the forward kernels
(``fwd_mma_kernel``, ``fwd_fma_kernel``, ``fma1_kernel`` in
``csrc/fwd_cluster.cuh``, ``fwd_wide_kernel`` in ``csrc/fwd_wide.cuh``,
fp32 and bf16 products, the latter at DeepSpeech2's training forward) at
the main paths' and bench shapes, for the LSTM, the GRU and the tanh cell
forward and backward (the tanh cell's on the wide branch too, fp32 at the
bench shape), and the grid forward (``csrc/lstm_fwd.cuh``) at the bench
shape: the cycles a step spends in each phase, and the clusters the
card holds at once; then, built without the stamps, the bf16 wide form
(``wide_bf16``) timed in turns beside the 32-row cluster that the launcher
takes at the TIMIT bench shape.

    python3 tools/probe_bwd_steps.py

Builds the headers with ``BWD_STEP_STAMPS``, ``FWD_STEP_STAMPS`` and
``GRID_STEP_STAMPS`` defined
(thread 0 of the first CTA adds ``clock64()`` deltas between the kernels'
phases) and the small main below into the git-ignored
``csrc/build/probes/`` with nvcc for sm_90a, and runs it.  The stamps cost
cycles of their own; the package's build leaves them out.
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
# (fma1_kernel: the product with its reduce-scatter, then the tanh step)
FWD_PHASES = ["product", "gate math", "DSMEM stores", "release arrive",
              "loads and global stores issued", "wait"]

# the grid forward's step (lstm_fwd.cuh); staging and product are summed
# over the step's k-tiles
GRID_PHASES = ["gate inputs and the first tile issued",
               "staging (cp.async waits and the barrier)",
               "product (and the barrier after each tile)",
               "gate math and stores", "grid.sync()"]

# the wide branch's step (fwd_wide.cuh), stamped by warp 0 (a k split 0)
WIDE_PHASES = ["the flags (the one-gate cell's staged h: and its copy)",
               "product", "the k splits' barrier and sum", "gate math",
               "exchange, flag and stores"]

# the wide backward's step (bwd_wide.cuh), stamped by thread 0 (an
# element-wise owner and a writer)
WIDE_BWD_PHASES = ["the flags", "receive sum", "element-wise step and dgx "
                   "issued", "next loads issued", "CTA barrier",
                   "product and exchange stores", "fence and flag"]

# the grid backward's step (lstm_bidir_train.cu); staging and product are
# summed over the step's k-tiles of dpre
GRID_BWD_PHASES = ["the first tile issued",
                   "staging (cp.async waits and the barrier)",
                   "product (and the barrier after each tile)",
                   "cell backward, dgx and the exchange write", "grid.sync()"]

MAIN = r"""
#include "fwd_cluster.cuh"
#include "lstm_bidir_train.cu"  // the grid backward's launcher
#include <cstdio>

#include <type_traits>

// one forward launch on the branch the launcher picks, with its stamps
template <class Cell, typename S, bool kRound>
void run_fwd(int T, int B, int H, const char* what) {
  const int G = Cell::kGates, ndir = 2;
  const size_t n_gx = (size_t)T * B * ndir * G * H, n_y = (size_t)T * B * ndir * H;
  void *gx, *ys, *cs;
  float* w;
  cudaMalloc(&gx, n_gx * sizeof(S));
  cudaMalloc(&ys, n_y * sizeof(S));
  cudaMalloc(&cs, n_y * sizeof(S));
  cudaMalloc(&w, (size_t)ndir * H * G * H * 4);
  cudaMemset(gx, 0, n_gx * sizeof(S));
  cudaMemset(cs, 0, n_y * sizeof(S));
  cudaMemset(w, 0, (size_t)ndir * H * G * H * 4);
  int branch = 0;
  fwd_branch<Cell, S, kRound>(B, H, ndir, &branch);
  if (branch == kFwdGrid) {
    printf("%s: grid branch, no stamps\n", what);
    return;
  }
  void *hx = nullptr, *flags = nullptr;
  const bool wide = branch == kFwdWide || branch == kFwdWideBf16;
  if (wide) {
    cudaMalloc(&hx, branch == kFwdWideBf16 ? wide_hx_bf16(B, H, ndir) * 2
                                           : wide_hx_floats(B, H, ndir) * 4);
    cudaMalloc(&flags, wide_flag_ints(B, H, ndir) * 4);
  }
  void* c = std::is_same<Cell, LstmCell>::value && kRound ? cs : nullptr;
  // the tanh backward reads a saved ys plane beside dy (gx here)
  const void* y_in = kBackward<Cell> ? cs : nullptr;
  for (int rep = 0; rep < 2; ++rep) {
    long long zero[8] = {0};
    cudaMemcpyToSymbol(fwd_step_cycles, zero, sizeof(zero));
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    cudaError_t err;
    if constexpr (kWideBf16<S, kRound> && Cell::kGates == 1) {
      // the one-gate cell has no bf16 wide form: its clusters or the grid
      err = launch_fwd_cluster<Cell, S, kRound>(branch, gx, w, ys, c, T, B, H,
                                                ndir, 0, y_in);
    } else {
      err = wide ? launch_fwd_wide<Cell, S, kRound>(gx, w, ys, c, hx, flags,
                                                    T, B, H, ndir, 0, y_in)
                 : launch_fwd_cluster<Cell, S, kRound>(branch, gx, w, ys, c,
                                                       T, B, H, ndir, 0, y_in);
    }
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    long long acc[8];
    cudaMemcpyFromSymbol(acc, fwd_step_cycles, sizeof(acc));
    long long total = 0;
    printf("%s: branch %d, %.4f ms, %.2f us a step; cycles a step by phase:",
           what, branch, ms, 1e3 * ms / T);
    for (int i = 0; i < 6; ++i) {
      printf(" %lld", acc[i] / T);
      total += acc[i];
    }
    printf(" | total %lld (%s)\n", total / T,
           cudaGetErrorString(err != cudaSuccess ? err : cudaGetLastError()));
  }
}

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

// one fp32 serial launch of the LSTM's or GRU's backward on the branch
// the launcher picks, with its stamps
template <class Cell>
void run_fma(int T, int B, int H, const char* what) {
  const int P = Cell::kPlanes, G = Cell::kGates, ndir = 2;
  const int Hp = (H + 3) / 4 * 4;
  const size_t n_planes = (size_t)ndir * T * P * B * Hp;
  const size_t n_w = (size_t)ndir * H * G * H, n_y = (size_t)T * B * ndir * H;
  float *planes, *w, *dy, *dgx, *dhhn;
  cudaMalloc(&planes, n_planes * 4);
  cudaMalloc(&w, n_w * 4);
  cudaMalloc(&dy, n_y * 4);
  cudaMalloc(&dgx, n_y * G * 4);
  cudaMalloc(&dhhn, n_y * 4);
  cudaMemset(planes, 0, n_planes * 4);
  cudaMemset(w, 0, n_w * 4);
  cudaMemset(dy, 0, n_y * 4);
  int branch = 0;
  cluster_branch<Cell>(B, H, ndir, 0, &branch);
  const FmaBwdShape f = fma_bwd_shape(G, H);
  if (branch != kBwdFma16) {
    printf("%s: branch %d, no stamps\n", what, branch);
    return;
  }
  for (int rep = 0; rep < 2; ++rep) {
    long long zero[16] = {0};
    cudaMemcpyToSymbol(bwd_step_cycles, zero, sizeof(zero));
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    const cudaError_t err = launch_bwd_fma<Cell>(
        planes, w, dy, dgx, std::is_same<Cell, GruCell>::value ? dhhn : nullptr,
        T, B, H, Hp, ndir, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    long long acc[16];
    cudaMemcpyFromSymbol(acc, bwd_step_cycles, sizeof(acc));
    long long total = 0;
    printf("%s: clusters of %d CTAs (Uc %d, %d threads, %d k slices, %zu B "
           "shared), %.4f ms, %.2f us a step; cycles a step by phase:",
           what, f.cl, f.uc, f.threads, f.ksn, f.smem, ms, 1e3 * ms / T);
    for (int i = 0; i < 11; ++i) {
      printf(" %lld", acc[i] / (T - 1));
      total += acc[i];
    }
    printf(" | total %lld (%s)\n", total / (T - 1),
           cudaGetErrorString(err != cudaSuccess ? err : cudaGetLastError()));
  }
}

// one fp32 serial launch of the LSTM's or GRU's wide backward, with its
// stamps (whatever the launcher would pick)
template <class Cell>
void run_wide_bwd(int T, int B, int H, const char* what) {
  const int P = Cell::kPlanes, G = Cell::kGates, ndir = 2;
  const int Hp = (H + 3) / 4 * 4;
  const size_t n_planes = (size_t)ndir * T * P * B * Hp;
  const size_t n_w = (size_t)ndir * H * G * H, n_y = (size_t)T * B * ndir * H;
  float *planes, *w, *dy, *dgx, *dhhn, *xbuf;
  int* flags;
  size_t n_x = 0, n_flags = 0;
  bwd_wide_scratch<Cell>(B, H, ndir, &n_x, &n_flags);
  cudaMalloc(&planes, n_planes * 4);
  cudaMalloc(&w, n_w * 4);
  cudaMalloc(&dy, n_y * 4);
  cudaMalloc(&dgx, n_y * G * 4);
  cudaMalloc(&dhhn, n_y * 4);
  cudaMalloc(&xbuf, n_x * 4);
  cudaMalloc(&flags, n_flags * 4);
  cudaMemset(planes, 0, n_planes * 4);
  cudaMemset(w, 0, n_w * 4);
  cudaMemset(dy, 0, n_y * 4);
  int sms = 0;
  device_sms(&sms);
  const BwdWideShape s = bwd_wide_shape(G, H, B, ndir, sms);
  bool fit = false;  // and raises the kernel's shared memory limit
  bwd_wide_fits<Cell>(B, H, ndir, &fit);
  if (!fit) {
    printf("%s: the wide backward does not fit, no stamps\n", what);
    return;
  }
  for (int rep = 0; rep < 2; ++rep) {
    long long zero[16] = {0};
    cudaMemcpyToSymbol(bwd_step_cycles, zero, sizeof(zero));
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    const cudaError_t err = launch_bwd_wide<Cell>(
        planes, w, dy, dgx, std::is_same<Cell, GruCell>::value ? dhhn : nullptr,
        xbuf, flags, T, B, H, Hp, ndir, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    long long acc[16];
    cudaMemcpyFromSymbol(acc, bwd_step_cycles, sizeof(acc));
    long long total = 0;
    printf("%s: Uc %d, RB %d, %d CTAs of %d warps (%zu B shared), %.4f ms, "
           "%.2f us a step; cycles a step by phase:",
           what, s.uc, s.rb, ndir * s.nr * s.nj, s.warps, s.smem, ms,
           1e3 * ms / T);
    for (int i = 0; i < 7; ++i) {
      printf(" %lld", acc[i] / (T - 1));
      total += acc[i];
    }
    printf(" | total %lld (%s)\n", total / (T - 1),
           cudaGetErrorString(err != cudaSuccess ? err : cudaGetLastError()));
  }
}

// one fp32 launch of the LSTM's grid backward (lstm_bidir_train.cu),
// whatever the launcher would pick, with its stamps
void run_grid_bwd(int T, int B, int H, const char* what) {
  const int P = LstmCell::kPlanes, ndir = 2, ldh = (B + 3) / 4 * 4;
  const int Hp = (H + 3) / 4 * 4;
  const size_t n_planes = (size_t)ndir * T * P * B * Hp;
  const size_t n_w = (size_t)ndir * H * 4 * H, n_y = (size_t)T * B * ndir * H;
  float *planes, *w, *dy, *dgx, *dpbuf, *dhbuf, *dcbuf;
  cudaMalloc(&planes, n_planes * 4);
  cudaMalloc(&w, n_w * 4);
  cudaMalloc(&dy, n_y * 4);
  cudaMalloc(&dgx, n_y * 4 * 4);
  cudaMalloc(&dpbuf, (size_t)ndir * 2 * 4 * H * ldh * 4);
  cudaMalloc(&dhbuf, (size_t)ndir * B * H * 4);
  cudaMalloc(&dcbuf, (size_t)ndir * B * H * 4);
  cudaMemset(planes, 0, n_planes * 4);
  cudaMemset(w, 0, n_w * 4);
  cudaMemset(dy, 0, n_y * 4);
  for (int rep = 0; rep < 2; ++rep) {
    long long zero[8] = {0};
    cudaMemcpyToSymbol(grid_step_cycles, zero, sizeof(zero));
    cudaMemset(dpbuf, 0, (size_t)ndir * 2 * 4 * H * ldh * 4);
    cudaMemset(dhbuf, 0, (size_t)ndir * B * H * 4);
    cudaMemset(dcbuf, 0, (size_t)ndir * B * H * 4);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    const cudaError_t err =
        launch_bwd<float>(planes, w, dy, dgx, dpbuf, dhbuf, dcbuf, T, B, H, Hp,
                          ldh, ndir, kBwdGrid, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    long long acc[8];
    cudaMemcpyFromSymbol(acc, grid_step_cycles, sizeof(acc));
    long long total = 0;
    printf("%s: grid, %.4f ms, %.2f us a step; cycles a step by phase:", what,
           ms, 1e3 * ms / T);
    for (int i = 0; i < 5; ++i) {
      printf(" %lld", acc[i] / T);
      total += acc[i];
    }
    printf(" | total %lld (%s)\n", total / T,
           cudaGetErrorString(err != cudaSuccess ? err : cudaGetLastError()));
  }
}

// one launch of the grid forward (lstm_fwd.cuh), whatever the launcher
// would pick, with its stamps
template <typename S, bool kTrain>
void run_grid(int T, int B, int H, const char* what) {
  const int ndir = 2, ldh = (B + 3) / 4 * 4;
  const size_t n_gx = (size_t)T * B * ndir * 4 * H, n_y = (size_t)T * B * ndir * H;
  void *gx, *ys, *cs;
  float *w, *hbuf, *cbuf;
  cudaMalloc(&gx, n_gx * sizeof(S));
  cudaMalloc(&ys, n_y * sizeof(S));
  cudaMalloc(&cs, n_y * sizeof(S));
  cudaMalloc(&w, (size_t)ndir * H * 4 * H * 4);
  cudaMalloc(&hbuf, (size_t)ndir * 2 * H * ldh * 4);
  cudaMalloc(&cbuf, (size_t)ndir * B * H * 4);
  cudaMemset(gx, 0, n_gx * sizeof(S));
  cudaMemset(w, 0, (size_t)ndir * H * 4 * H * 4);
  for (int rep = 0; rep < 2; ++rep) {
    long long zero[8] = {0};
    cudaMemcpyToSymbol(grid_step_cycles, zero, sizeof(zero));
    cudaMemset(hbuf, 0, (size_t)ndir * 2 * H * ldh * 4);
    cudaMemset(cbuf, 0, (size_t)ndir * B * H * 4);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    const cudaError_t err = launch<S, kTrain>(gx, w, ys, kTrain ? cs : nullptr,
                                              hbuf, cbuf, T, B, H, ldh, ndir, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    long long acc[8];
    cudaMemcpyFromSymbol(acc, grid_step_cycles, sizeof(acc));
    long long total = 0;
    printf("%s: grid, %.4f ms, %.2f us a step; cycles a step by phase:", what,
           ms, 1e3 * ms / T);
    for (int i = 0; i < 5; ++i) {
      printf(" %lld", acc[i] / T);
      total += acc[i];
    }
    printf(" | total %lld (%s)\n", total / T,
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
  printf("backward, fp32 streams (phase 3 the element-wise step with dgx "
         "issued, 6 the product and the reduce-scatter, 10 empty)\n");
  run_fma<LstmCell>(100, 8, 384, "lstm T=100 B=8 H=384 fp32");
  run_fma<LstmCell>(400, 8, 256, "lstm T=400 B=8 H=256 fp32");
  run_fma<LstmCell>(100, 4, 384, "lstm T=100 B=4 H=384 fp32");
  run_fma<GruCell>(95, 8, 256, "gru T=95 B=8 H=256 fp32");
  run_fma<GruCell>(195, 8, 256, "gru T=195 B=8 H=256 fp32");
  printf("backward, fp32 streams, wide branch\n");
  run_wide_bwd<LstmCell>(80, 128, 384, "lstm T=80 B=128 H=384 fp32");
  run_wide_bwd<LstmCell>(80, 64, 384, "lstm T=80 B=64 H=384 fp32");
  run_wide_bwd<GruCell>(95, 128, 256, "gru T=95 B=128 H=256 fp32");
  printf("backward, fp32 streams, grid\n");
  run_grid_bwd(80, 128, 384, "lstm T=80 B=128 H=384 fp32");
  run_grid_bwd(80, 64, 384, "lstm T=80 B=64 H=384 fp32");
  printf("forward\n");
  run_fwd<LstmCell, float, false>(100, 8, 384, "lstm eval T=100 B=8 H=384 fp32");
  run_fwd<LstmCell, float, true>(100, 8, 384, "lstm train T=100 B=8 H=384 fp32");
  run_fwd<LstmCell, __nv_bfloat16, true>(80, 128, 384,
                                         "lstm train T=80 B=128 H=384 bf16");
  run_fwd<GruCell, __nv_bfloat16, true>(95, 16, 256, "gru T=95 B=16 H=256 bf16");
  run_fwd<GruCell, __nv_bfloat16, true>(95, 128, 256, "gru T=95 B=128 H=256 bf16");
  printf("forward, wide branch (branch 4)\n");
  run_fwd<LstmCell, float, false>(80, 128, 384, "lstm eval T=80 B=128 H=384 fp32");
  run_fwd<LstmCell, float, false>(80, 64, 384, "lstm eval T=80 B=64 H=384 fp32");
  run_fwd<LstmCell, float, true>(80, 128, 384, "lstm train T=80 B=128 H=384 fp32");
  run_fwd<GruCell, float, true>(95, 128, 256, "gru T=95 B=128 H=256 fp32");
  printf("forward, the wide branch's bf16 form (branch 5)\n");
  run_fwd<LstmCell, __nv_bfloat16, true>(1200, 64, 1024,
                                         "lstm train T=1200 B=64 H=1024 bf16");
  run_fwd<GruCell, __nv_bfloat16, true>(95, 128, 512,
                                        "gru T=95 B=128 H=512 bf16");
  printf("grid forward\n");
  run_grid<float, false>(80, 128, 384, "lstm eval T=80 B=128 H=384 fp32");
  run_grid<__nv_bfloat16, false>(80, 128, 384, "lstm eval T=80 B=128 H=384 bf16");
  run_grid<float, false>(80, 64, 384, "lstm eval T=80 B=64 H=384 fp32");
  run_grid<float, true>(80, 128, 384, "lstm train T=80 B=128 H=384 fp32");
  printf("tanh forward and backward\n");
  run_fwd<TanhCell, float, true>(100, 8, 384, "tanh fwd T=100 B=8 H=384 fp32");
  run_fwd<TanhBwdCell, float, true>(100, 8, 384, "tanh bwd T=100 B=8 H=384 fp32");
  run_fwd<TanhCell, __nv_bfloat16, true>(80, 128, 384,
                                         "tanh fwd T=80 B=128 H=384 bf16");
  run_fwd<TanhBwdCell, __nv_bfloat16, true>(80, 128, 384,
                                            "tanh bwd T=80 B=128 H=384 bf16");
  printf("tanh forward and backward, fp32 streams, wide branch (branch 4)\n");
  run_fwd<TanhCell, float, true>(80, 128, 384, "tanh fwd T=80 B=128 H=384 fp32");
  run_fwd<TanhBwdCell, float, true>(80, 128, 384,
                                    "tanh bwd T=80 B=128 H=384 fp32");
  return 0;
}
"""


# The bf16 form of the wide forward beside the launcher's own branch (the
# 32-row cluster) at the TIMIT bench shape, built without the stamps:
# median of five launches each, in turns
TURNS = r"""
#include "fwd_cluster.cuh"
#include <algorithm>
#include <cstdio>

template <class Cell>
void turns(int T, int B, int H, const char* what) {
  using S = __nv_bfloat16;
  const int G = Cell::kGates, ndir = 2;
  const size_t n_gx = (size_t)T * B * ndir * G * H, n_y = (size_t)T * B * ndir * H;
  void *gx, *ys, *cs, *hx, *flags;
  float* w;
  cudaMalloc(&gx, n_gx * sizeof(S));
  cudaMalloc(&ys, n_y * sizeof(S));
  cudaMalloc(&cs, n_y * sizeof(S));
  cudaMalloc(&w, (size_t)ndir * H * G * H * 4);
  cudaMemset(gx, 0, n_gx * sizeof(S));
  cudaMemset(w, 0, (size_t)ndir * H * G * H * 4);
  cudaMalloc(&hx, wide_hx_bf16(B, H, ndir) * 2);
  cudaMalloc(&flags, wide_flag_ints(B, H, ndir) * 4);
  void* c = std::is_same<Cell, LstmCell>::value ? cs : nullptr;
  int branch = 0;
  bool fit = false;
  fwd_branch<Cell, S, true>(B, H, ndir, &branch);
  wide_fits<Cell, S, true>(B, H, ndir, &fit);
  if (branch == kFwdGrid || !fit) {
    printf("%s: branch %d, wide_bf16 fits %d: no turns\n", what, branch, fit);
    return;
  }
  float ms[2][5];
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaError_t err = cudaSuccess;
  for (int rep = -1; rep < 5; ++rep) {  // rep -1 warms both up
    for (int k = 0; k < 2; ++k) {
      cudaEventRecord(a);
      const cudaError_t e =
          k == 0 ? launch_fwd_cluster<Cell, S, true>(branch, gx, w, ys, c, T, B,
                                                     H, ndir, 0)
                 : launch_fwd_wide<Cell, S, true>(gx, w, ys, c, hx, flags, T, B,
                                                  H, ndir, 0);
      if (e != cudaSuccess) err = e;
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      if (rep >= 0) cudaEventElapsedTime(&ms[k][rep], a, b);
    }
  }
  for (int k = 0; k < 2; ++k) std::sort(ms[k], ms[k] + 5);
  printf("%s: branch %d %.4f ms (%.2f us a step), wide_bf16 %.4f ms (%.2f us "
         "a step), wide / branch %.3f (%s)\n", what, branch, ms[0][2],
         1e3 * ms[0][2] / T, ms[1][2], 1e3 * ms[1][2] / T, ms[1][2] / ms[0][2],
         cudaGetErrorString(err != cudaSuccess ? err : cudaGetLastError()));
}

int main() {
  turns<LstmCell>(80, 128, 384, "lstm train T=80 B=128 H=384 bf16");
  turns<GruCell>(95, 128, 448, "gru T=95 B=128 H=448 bf16");
  return 0;
}
"""


def main() -> int:
    out = BUILD_DIR / "probes"
    out.mkdir(parents=True, exist_ok=True)
    cu, exe = out / "step_stamps.cu", out / "step_stamps"
    cu.write_text(MAIN)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-DBWD_STEP_STAMPS", "-DFWD_STEP_STAMPS",
                    "-DGRID_STEP_STAMPS",
                    f"-I{CSRC}", "-o", str(exe), str(cu)], check=True)
    print("backward phases:", ", ".join(PHASES))
    print("forward phases:", ", ".join(FWD_PHASES))
    print("wide forward phases:", ", ".join(WIDE_PHASES))
    print("wide backward phases:", ", ".join(WIDE_BWD_PHASES))
    print("grid backward phases:", ", ".join(GRID_BWD_PHASES))
    print("grid forward phases:", ", ".join(GRID_PHASES))
    subprocess.run([str(exe)], check=True)
    cu, exe = out / "wide_bf16_turns.cu", out / "wide_bf16_turns"
    cu.write_text(TURNS)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", f"-I{CSRC}", "-o", str(exe), str(cu)],
                   check=True)
    print("the bf16 wide form beside the 32-row cluster, no stamps:")
    subprocess.run([str(exe)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
