// Tanh-RNN forward recurrence, for eval and decode and for the forward of
// training, one launch per layer, for Hopper (sm_90a): the cluster branches
// of fwd_cluster.cuh and the grid branch below.
//
// Replaces ctc_pytorch_tpu/ops/rnn_pallas_v2.py:_fwd_pallas (the Pallas
// kernel _make_fwd_kernel, cell _rnn_cell2), which rnn_bidir_v2(train=False)
// reaches with_guard=False and rnn_scan_v2 with_guard=True.  Same function:
//   gx (T, B, ndir * H) in the stream type S (fp32 or bf16), lanes [0,H) the
//   forward direction's inputs, [H,2H) the backward direction's;
//   w_hh (ndir, H, H), rounded to S by the caller; h0 = 0; ndir 1 or 2.
//   Direction 0 walks t = 0..T-1, direction 1 walks t = T-1..0, and
//   ys[t, :, d*H:(d+1)*H] = h_d(t) rounded to S.  Per step
//     h = tanh(gx_t + round_S(h) @ w_hh)      (sums and tanh in fp32)
//   The cell reads h only through the product, which takes it rounded to S,
//   so h is kept only as ys holds it.
//
// What bounds it: the T steps are a serial chain, and each step is a small
// product (B, H) @ (H, H) per direction.  At the TIMIT bench shape (T'=80,
// B=128, H=384) the products are 6.04 GFLOP per layer and the bytes (gx, ys,
// w_hh) 32.1 MB with bf16 streams.  With bf16 streams both operands of the
// product are bf16 values, which the tensor cores multiply at 989 TFLOP/s
// (~0.006 ms), so the card's limit is the bytes, ~0.010 ms at 3.35 TB/s;
// with fp32 streams it is the fp32 operations at 67 TFLOP/s.  The kernels
// are far above both: the step's latency sets their time.
//
// Cluster branches (fwd_cluster.cuh, TanhCell): a thread-block cluster per
// direction and 16 or 32 batch rows, w_hh resident across its CTAs, h
// exchanged in distributed shared memory, one cluster barrier a step.  bf16
// streams: fwd_mma_kernel, the tensor cores (H <= 512); fp32 streams:
// fma1_kernel, fp32 FMA with four adjacent units to a float4 (H <= 558 with
// 8 CTAs, H <= 726 with 16).  A cluster branch is taken only where every
// cluster of the launch is resident at once.
//
// Wide branch, fp32 streams where no fp32 cluster fits (B >= 113 at H =
// 384 with two directions: 16 clusters of 8 one-CTA-per-SM blocks are more
// than the card holds; H past 726): fwd_wide_kernel<TanhCell>
// (fwd_wide.cuh), one persistent cooperative CTA an SM owning Uc units x
// RB rows with their w_hh columns resident, the product in 3xTF32 on
// mma.sync, h exchanged through L2 under per-block step flags, to the bound
// the header states (H <= 792 at B = 128).  The grid below spends a step
// on an fp32 FMA product and a grid barrier; the wide branch's step is the
// exchange and a quarter of the LSTM's 3xTF32 product (PERF.md row 9 has
// both branches' times).
//
// Grid branch, every other shape: the GRU forward's grid (gru_bidir.cu)
// with one product per unit.  One persistent cooperative grid; CTA (d, g)
// owns 8 hidden units of direction d and keeps the matching 8 columns of
// w_hh[d] in shared memory for the whole run, H * 8 floats (not the float4
// per (k, unit) of the gated cells).  Each thread owns one hidden unit and 4
// batch rows.  h_{t-1}, rounded to S, lives transposed, (H, ldh), in a
// global double buffer (L2) that every CTA streams through shared memory in
// k-tiles with cp.async, two tiles in flight; then the grid meets at
// grid.sync().  A CTA needs 32*H + 64 KB of shared memory, so two CTAs fit
// on an SM while H <= 1568, and the ndir * ceil(H/8) CTAs are co-resident
// while they number at most 2 * SMs: H <= 1056 with two directions on a
// 132-SM H100, H <= 1568 with one.  Past that a co-resident grid strides
// over the (d, g) items and reads w_hh from L2, so any H runs.  The grid's
// device code lives in rnn_fwd.cuh; the trainable op's forward launches
// this same entry.

#include "fwd_cluster.cuh"
#include "rnn_fwd.cuh"

extern "C" {

// The forward's branch for this shape on the current device: *branch 0 the
// grid, 1 or 2 the bf16 cluster of 16 or 32 rows, 3 the fp32 cluster, 4 the
// wide branch (FwdBranch).  Returns a cudaError_t.
int rnn_bidir_fwd_branch(int B, int H, int ndir, int bf16, int* branch) {
  return (int)(bf16 ? fwd_branch<TanhCell, __nv_bfloat16, true>(B, H, ndir, branch)
                    : fwd_branch<TanhCell, float, true>(B, H, ndir, branch));
}

// gx (T, B, ndir * H) and ys (T, B, ndir * H) in the stream type (bf16 != 0:
// bfloat16, else float32); w_hh (ndir, H, H) fp32, already rounded to the
// stream type; ndir 1 or 2.  hbuf and flags: for the grid branch hbuf is
// (ndir, 2, H, ldh) fp32 zeros with ldh >= B a multiple of 4 and flags null;
// for the wide branch the exchange buffer and the step flags
// (wide_hx_floats, wide_flag_ints; the flags are zeroed on the stream);
// null for the clusters.  *branch: the branch launched, as
// rnn_bidir_fwd_branch numbers them.  Returns a cudaError_t; 0 means
// launched.
int rnn_bidir_forward(const void* gx, const void* w_hh, void* ys, void* hbuf,
                      void* flags, int T, int B, int H, int ldh, int ndir,
                      int bf16, void* stream, int* branch) {
  *branch = -1;
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  int plan = 0;
  cudaError_t err = (cudaError_t)rnn_bidir_fwd_branch(B, H, ndir, bf16, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan == kFwdGrid) {
    if (!hbuf) return (int)cudaErrorInvalidValue;
    err = bf16 ? rnn_launch<__nv_bfloat16>(gx, w_hh, ys, hbuf, T, B, H, ldh,
                                           ndir, st)
               : rnn_launch<float>(gx, w_hh, ys, hbuf, T, B, H, ldh, ndir, st);
  } else if (plan == kFwdWide) {  // fp32 streams only: bf16 rounds the product
    err = bf16 ? cudaErrorInvalidValue
               : launch_fwd_wide<TanhCell, float, true>(
                     gx, w_hh, ys, nullptr, hbuf, flags, T, B, H, ndir, st);
  } else {
    err = bf16 ? launch_fwd_cluster<TanhCell, __nv_bfloat16, true>(
                     plan, gx, w_hh, ys, nullptr, T, B, H, ndir, st)
               : launch_fwd_cluster<TanhCell, float, true>(
                     plan, gx, w_hh, ys, nullptr, T, B, H, ndir, st);
  }
  if (err == cudaSuccess) *branch = plan;
  return (int)err;
}

const char* rnn_bidir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
