// Bidirectional GRU forward recurrence, for eval and decode and for the
// forward of training, one launch per layer, for Hopper (sm_90a): a cluster
// branch (fwd_cluster.cuh) and the grid branch below.
//
// Replaces ctc_pytorch_tpu/ops/gru_pallas_v2.py:_fwd_pallas (the Pallas
// kernel _make_fwd_kernel, cell _gru_cell2), which gru_bidir_v2(train=False)
// reaches with_guard=False and gru_scan_train_v2 with_guard=True.  Same
// function:
//   gx (T, B, 6H) in the stream type S (fp32 or bf16), lanes [0,3H) are the
//   forward direction's gate inputs, [3H,6H) the backward direction's;
//   w_hh (2, H, 3H), gate order r, z, n, rounded to S by the caller; h0 = 0.
//   Direction 0 walks t = 0..T-1, direction 1 walks t = T-1..0, and
//   ys[t, :, d*H:(d+1)*H] = h_d(t) rounded to S; a unidirectional layer is
//   the launch with one direction (ndir = 1).  Per step
//     hh = round_S(h) @ w_hh          (sums in fp32)
//     r = sigmoid(gx_r + hh_r), z = sigmoid(gx_z + hh_z)
//     n = tanh(gx_n + r * hh_n),  h = (1 - z) * n + z * h
//   with the carry h and the gate math in fp32.
//
// What bounds it: the T steps are a serial chain with a grid-wide barrier
// each, and each step is a small product (B, H) @ (H, 3H) per direction on
// CUDA cores.  At the 863 bench shape (T'=95, B=128, H=256) the products are
// 9.56 GFLOP per layer and the bytes (gx, ys, w_hh) 51 MB with bf16 streams.
// With bf16 streams both operands of the product are bf16 values, which the
// tensor cores multiply at 989 TFLOP/s (~0.010 ms), so the card's limit is
// the bytes, ~0.015 ms at 3.35 TB/s; with fp32 streams it is the fp32
// operations, ~0.14 ms at 67 TFLOP/s.  The kernel is far above both: the
// barriers and the L2 round trips inside each step set its time.
//
// Grid branch: the LSTM eval kernel's (lstm_bidir.cu), with three gates.  One
// persistent cooperative grid; CTA (d, g) owns 8 hidden units of direction d
// and keeps the matching r, z and n columns of w_hh[d] in shared memory for
// the whole run.  Each thread owns one hidden unit and 4 batch rows and
// holds the three recurrent products apart in registers, so r meets hh_n
// with no exchange inside the CTA; the fp32 carry stays in a global scratch
// that only its owning thread touches.  h_{t-1}, rounded to S, lives
// transposed, (H, ldh), in a global double buffer (L2) that every CTA
// streams through shared memory in k-tiles with cp.async, two tiles in
// flight; then the grid meets at grid.sync().  A CTA needs 128*H + 64 KB of
// shared memory (the weights are padded to a float4 per unit), so the
// 2*ceil(H/8) CTAs are co-resident while H <= 4 * SMs (528 on a 132-SM
// H100): 64 CTAs at H = 256.  Past that a co-resident grid strides over the
// (d, g) items and reads w_hh from L2, so any H runs.
// That grid is now the branch for the shapes that no other holds: the
// cluster branch of fwd_cluster.cuh (a thread-block cluster per direction
// and 16 or 32 batch rows, w_hh resident across it, h exchanged in
// distributed shared memory, one cluster barrier a step; the products on
// the tensor cores with bf16 streams) takes what its clusters hold, and
// with fp32 streams the wide branch of fwd_wide.cuh (one CTA an SM, 3xTF32
// on the tensor cores, h exchanged through L2 under step flags) takes the
// wider batches (B = 128 at H = 256) up to its bound (H <= 1056).  The grid's device
// code lives in gru_fwd.cuh; the trainable op's forward launches this same
// entry.

#include "fwd_cluster.cuh"

extern "C" {

// The forward's branch for this shape on the current device: *branch 0 the
// grid, 1 or 2 the bf16 cluster of 16 or 32 rows, 3 the fp32 cluster, 4
// the wide branch on fp32 streams, 5 on bf16 streams (FwdBranch).  Returns a
// cudaError_t.
int gru_bidir_fwd_branch(int B, int H, int ndir, int bf16, int* branch) {
  return (int)(bf16 ? fwd_branch<GruCell, __nv_bfloat16, true>(B, H, ndir, branch)
                    : fwd_branch<GruCell, float, true>(B, H, ndir, branch));
}

// See gru_forward in gru_fwd.cuh for the arguments; hbuf and hcarry are
// the grid branch's scratch, or the wide branch's exchange buffer and step
// flags (lstm_bidir.cu says their sizes), null for the clusters.
// *branch: the branch launched, as gru_bidir_fwd_branch numbers them.
// Returns a cudaError_t; 0 means launched.
int gru_bidir_forward(const void* gx, const void* w_hh, void* ys, void* hbuf,
                      void* hcarry, int T, int B, int H, int ldh, int ndir,
                      int bf16, void* stream, int* branch) {
  *branch = -1;
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  int plan = 0;
  cudaError_t err = (cudaError_t)gru_bidir_fwd_branch(B, H, ndir, bf16, &plan);
  if (err != cudaSuccess) return (int)err;
  if (plan == kFwdGrid) {
    if (!hbuf || !hcarry) return (int)cudaErrorInvalidValue;
    err = gru_forward(gx, w_hh, ys, hbuf, hcarry, T, B, H, ldh, ndir, bf16,
                      stream);
  } else if (plan == kFwdWide || plan == kFwdWideBf16) {
    // wide_fp32 on fp32 streams, wide_bf16 on bf16 streams
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = bf16 ? launch_fwd_wide<GruCell, __nv_bfloat16, true>(
                     gx, w_hh, ys, nullptr, hbuf, hcarry, T, B, H, ndir, st)
               : launch_fwd_wide<GruCell, float, true>(
                     gx, w_hh, ys, nullptr, hbuf, hcarry, T, B, H, ndir, st);
  } else {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = bf16 ? launch_fwd_cluster<GruCell, __nv_bfloat16, true>(
                     plan, gx, w_hh, ys, nullptr, T, B, H, ndir, st)
               : launch_fwd_cluster<GruCell, float, true>(
                     plan, gx, w_hh, ys, nullptr, T, B, H, ndir, st);
  }
  if (err == cudaSuccess) *branch = plan;
  return (int)err;
}

const char* gru_bidir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
