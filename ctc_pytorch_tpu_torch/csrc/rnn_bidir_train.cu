// Trainable tanh-RNN recurrence for Hopper (sm_90a): the backward kernels.
//
// Replaces the backward pallas_call of
// ctc_pytorch_tpu/ops/rnn_pallas_v2.py:rnn_scan_v2 (_bwd_pallas, kernel
// _make_bwd_kernel).  Its forward pallas_call (_fwd_pallas with_guard=True)
// is the eval kernel of rnn_bidir.cu: the cell saves nothing but ys, and
// the TPU kernel's guard rows are its own memory management.
//
// Backward: given w_hh (ndir, H, H), ys and dy (T, B, ndir * H) in the
// stream type S, it walks direction 0 from t = T-1 down and direction 1 from
// t = 0 up, and per step
//   dpre = (dy_t + dh) * (1 - y_t^2)      y_t read back from ys (rounded)
//   dgx[t] = dpre, stored in S
//   dh = round_S(dpre) @ w_hh^T           (sums in fp32; dh = 0 at first)
// The tanh cell needs no gate recompute: its derivative comes from the
// stored output.  dh_{t-1} contracts over all H units, so every CTA needs
// every CTA's dpre of this step.
//
// What bounds it: the serial chain of T steps, as the forward.  The card's
// limits are far below: one (B, H) x (H, H) product per step and direction,
// 6.04 GFLOP at T'=80, B=128, H=384, and ys, dy in, dgx out, ~47.8 MB with
// bf16 streams.  With bf16 streams both operands of the product are bf16
// values (tensor cores: ~0.006 ms), so the limit is the bytes, ~0.014 ms at
// 3.35 TB/s; with fp32 streams it is the fp32 operations at 67 TFLOP/s.
//
// The step has the forward's shape exactly: a value exchanged every step
// (dpre, as h) feeds a (B, H) x (H, H) product, and the per-(row, unit)
// step reads planes in place.  So the cluster branches are the forward's
// kernels of fwd_cluster.cuh with the backward cell (TanhBwdCell): the
// resident weights are rows of w_hh (columns of w_hh^T), the step reads dy
// and ys (two planes in place of gx), stores dgx in S and exchanges dpre as
// S holds it, and time runs the other way.  bf16 streams: fwd_mma_kernel,
// the tensor cores (H <= 512); fp32 streams: fma1_kernel (H <= 558 with 8
// CTAs, H <= 726 with 16); only where every cluster of the launch is
// resident at once.  There is nothing to hoist (the LSTM's and GRU's
// pre-pass of bwd_hoist.cuh): 1 - y^2 is one multiply on a saved plane.
//
// Wide branch, fp32 streams where no fp32 cluster fits (B >= 113 at H =
// 384 with two directions; H past 726): the forward's wide kernel with the
// backward cell, fwd_wide_kernel<TanhBwdCell> (fwd_wide.cuh): one
// persistent cooperative CTA an SM owning Uc units x RB rows, the rows of
// w_hh its units meet resident, dpre exchanged through L2 under per-block
// step flags, the product dpre @ w_hh^T in 3xTF32 on mma.sync, time
// reversed; to the bound the header states (H <= 792 at B = 128).  Not
// bwd_wide.cuh: that kernel forms each CTA's partial dh over its own G Uc
// gate columns from the gated cells' pre-pass planes; here dpre is one
// plane, formed in the step, and the product contracts over H, the
// forward's shape.
//
// Grid branch, every other shape: the grid forward's design (rnn_fwd.cuh),
// whose product this step has the shape of: h @ w becomes dpre @ w^T.  CTA
// (d, g) owns 8 hidden units of direction d and keeps their 8 rows of
// w_hh[d] (columns of w_hh^T) in shared memory; each thread owns one unit
// and 4 batch rows.  Per step:
//   phase B  dh for the owned units: the product over the previous step's
//            round_S(dpre), which all CTAs wrote transposed, (H, ldh), into a
//            global double buffer (L2), streamed through shared memory with
//            cp.async; dh stays in the thread's registers;
//   phase C  dpre, dgx and the exchange write;
//   grid.sync().
// Shared memory and the co-residency bound are the forward's (rnn_bidir.cu).
// dW_hh is formed outside from shifted ys against dgx (plain GEMMs), as the
// JAX package does.

#include "fwd_cluster.cuh"
#include "rnn_fwd.cuh"

namespace {

// One backward time step of work item (d, u0) at forward time t.
template <typename S, bool kResident>
__device__ __forceinline__ void rnn_bwd_item(
    const float* __restrict__ w, const float* w_s, const S* __restrict__ ys,
    const S* __restrict__ dy, S* __restrict__ dgx, const float* dp_prev,
    float* dp_next, float* tiles, int t, bool first, int u0, int d, int B,
    int H, int ldh, int ndir) {
  const int tid = threadIdx.x;
  const int unit = u0 + tid % kUnits;
  const int rq = tid / kUnits;
  const size_t row = (size_t)ndir * H;  // lanes of a batch row of the planes
  const size_t plane = (size_t)t * B * row + (size_t)d * H;
  for (int r0 = 0; r0 < B; r0 += kRowTile) {
    // ---- phase B: dh[b, unit] = sum_j dpre_prev[j, b] * w[unit, j]
    float dh[kRows] = {0.f, 0.f, 0.f, 0.f};
    if (!first)
      rnn_product<kResident, true>(dp_prev, w, w_s, tiles, dh, r0, u0, B, H,
                                   ldh);
    // ---- phase C: dpre for the owned (row, unit) pairs
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      if (unit >= H || b >= B) continue;
      const size_t o = plane + (size_t)b * row + unit;
      const float y = load_f(ys + o);
      const float dpre = (load_f(dy + o) + dh[j]) * (1.0f - y * y);
      store_f(dgx + o, dpre);
      dp_next[(size_t)unit * ldh + b] = round_to(dpre, dgx);
    }
  }
}

template <typename S, bool kResident>
__global__ void __launch_bounds__(32 * kUnits)
    rnn_bwd_kernel(const float* __restrict__ w_hh, const S* __restrict__ ys,
                   const S* __restrict__ dy, S* __restrict__ dgx,
                   float* dpbuf, int T, int B, int H, int ldh, int ndir) {
  extern __shared__ float4 smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // kResident: [H][kUnits]
  float* tiles = w_s + (kResident ? (size_t)H * kUnits : 0);  // [2][tile]

  const int groups = (H + kUnits - 1) / kUnits;
  const int items = ndir * groups;
  const size_t hh = (size_t)H * H;

  if constexpr (kResident)  // w_s[k][u] = w_hh[d][u0 + u][k]: rows of w_hh[d]
    rnn_load_weights<true>(w_s, w_hh + (blockIdx.x / groups) * hh,
                           (blockIdx.x % groups) * kUnits, H);

  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < T; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int d = item / groups;
      float* dp = dpbuf + (size_t)d * 2 * H * ldh;  // [2][H][ldh], zeroed
      rnn_bwd_item<S, kResident>(
          w_hh + d * hh, w_s, ys, dy, dgx,
          dp + (size_t)((s + 1) & 1) * H * ldh, dp + (size_t)(s & 1) * H * ldh,
          tiles, d == 0 ? T - 1 - s : s, s == 0, (item % groups) * kUnits, d,
          B, H, ldh, ndir);
    }
    grid.sync();
  }
}

template <typename S>
cudaError_t rnn_launch_bwd(const void* w_hh, const void* ys, const void* dy,
                           void* dgx, void* dpbuf, int T, int B, int H,
                           int ldh, int ndir, cudaStream_t stream) {
  void* args[] = {&w_hh, &ys, &dy, &dgx, &dpbuf, &T, &B, &H, &ldh, &ndir};
  const int items = ndir * ((H + kUnits - 1) / kUnits);
  int fits = 0;
  cudaError_t err = launch_cooperative(
      reinterpret_cast<const void*>(rnn_bwd_kernel<S, true>),
      rnn_smem_bytes(H, true), items, true, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  err = launch_cooperative(
      reinterpret_cast<const void*>(rnn_bwd_kernel<S, false>),
      rnn_smem_bytes(H, false), items, false, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

extern "C" {

// The backward's branch for this shape on the current device: *branch 0 the
// grid, 1 or 2 the bf16 cluster of 16 or 32 rows, 3 the fp32 cluster, 4
// the wide branch (FwdBranch).  Returns a cudaError_t.
int rnn_bidir_train_bwd_branch(int B, int H, int ndir, int bf16, int* branch) {
  return (int)(bf16 ? fwd_branch<TanhBwdCell, __nv_bfloat16, true>(B, H, ndir,
                                                                    branch)
                    : fwd_branch<TanhBwdCell, float, true>(B, H, ndir, branch));
}

// ys, dy and dgx (T, B, ndir * H) in the stream type (bf16 != 0: bfloat16,
// else float32); w_hh (ndir, H, H) fp32, rounded to the stream type by the
// caller; ndir 1 or 2.  dpbuf and flags: for the grid branch dpbuf is
// (ndir, 2, H, ldh) fp32 zeros with ldh >= B a multiple of 4 and flags
// null; for the wide branch the exchange buffer and the step flags
// (wide_hx_floats, wide_flag_ints; the flags are zeroed on the stream);
// null for the clusters.  *branch: the branch launched, as
// rnn_bidir_train_bwd_branch numbers them.  Returns a cudaError_t; 0 means
// launched.
int rnn_bidir_train_backward(const void* w_hh, const void* ys, const void* dy,
                             void* dgx, void* dpbuf, void* flags, int T, int B,
                             int H, int ldh, int ndir, int bf16, void* stream,
                             int* branch) {
  *branch = -1;
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  int plan = 0;
  cudaError_t err =
      (cudaError_t)rnn_bidir_train_bwd_branch(B, H, ndir, bf16, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan == kFwdGrid) {
    if (!dpbuf) return (int)cudaErrorInvalidValue;
    err = bf16 ? rnn_launch_bwd<__nv_bfloat16>(w_hh, ys, dy, dgx, dpbuf, T, B,
                                               H, ldh, ndir, st)
               : rnn_launch_bwd<float>(w_hh, ys, dy, dgx, dpbuf, T, B, H, ldh,
                                       ndir, st);
  } else if (plan == kFwdWide) {  // fp32 streams only: bf16 rounds the product
    err = bf16 ? cudaErrorInvalidValue
               : launch_fwd_wide<TanhBwdCell, float, true>(
                     dy, w_hh, dgx, nullptr, dpbuf, flags, T, B, H, ndir, st,
                     ys);
  } else {
    err = bf16 ? launch_fwd_cluster<TanhBwdCell, __nv_bfloat16, true>(
                     plan, dy, w_hh, dgx, nullptr, T, B, H, ndir, st, ys)
               : launch_fwd_cluster<TanhBwdCell, float, true>(
                     plan, dy, w_hh, dgx, nullptr, T, B, H, ndir, st, ys);
  }
  if (err == cudaSuccess) *branch = plan;
  return (int)err;
}

const char* rnn_bidir_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
