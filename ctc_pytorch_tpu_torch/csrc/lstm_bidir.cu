// Bidirectional LSTM recurrence for eval and decode, one launch per layer,
// for Hopper (sm_90a): a cluster branch (fwd_cluster.cuh) and the grid
// branch below.
//
// Replaces ctc_pytorch_tpu/ops/lstm_pallas_v2.py:lstm_bidir_pallas_v2 (the
// Pallas kernel _make_kernel at :61, cell _cell2 at :42).  Same function:
//   gx (T, B, 8H) in the stream type S (fp32 or bf16), lanes [0,4H) are the
//   forward direction's gate inputs, [4H,8H) the backward direction's;
//   w_hh (2, H, 4H) fp32, gate order i, f, g, o; h0 = c0 = 0.
//   Direction 0 walks t = 0..T-1, direction 1 walks t = T-1..0, and
//   ys[t, :, d*H:(d+1)*H] = h_d(t) rounded to S.  Gate math, h and c are fp32.
//   A unidirectional layer launches the same kernel with one direction
//   (ndir = 1): gx (T, B, 4H), w_hh (1, H, 4H), ys (T, B, H).
//
// What bounds it: the T steps are a serial chain, and each step is a small
// fp32 product (B, H) @ (H, 4H) per direction on CUDA cores.  At the decode
// bench shape (T=80, B=128, H=384) the product is 24.2 GFLOP per layer,
// about 0.36 ms at the H100's 67 TFLOP/s fp32, while the bytes (gx, ys,
// w_hh: ~83 MB) take ~25 us at 3.35 TB/s: operations bound it, and the 80
// grid-wide barriers and the L2 round trips inside each step add a latency
// floor on top.
//
// Grid branch: one persistent cooperative grid.  CTA (d, g) owns U hidden units
// of direction d and keeps the matching 4*U columns of w_hh[d] in shared
// memory for the whole run, so the weights are read from device memory
// once.  Each thread owns one hidden unit and kRows batch rows and computes
// all four gates for them, so the cell update needs no exchange inside the
// CTA; c stays in a global scratch that only its owning thread touches.
// h_{t-1} lives transposed, (H, ldh), in a global double buffer (it stays
// in L2).  Each step every CTA streams it through shared memory in k-tiles
// with cp.async (L2 only, so it sees the other SMs' writes), two tiles in
// flight so one tile's copy overlaps the previous tile's products, then
// writes its slice of h_t and ys, and the grid meets at grid.sync().
// With U = 8 a CTA needs 128*H + 64 KB of shared memory, so above H = 392
// one CTA fits per SM, and the 2*ceil(H/8) CTAs are co-resident only while
// H <= 4 * SMs (528 on a 132-SM H100).  Past that a co-resident grid of one
// CTA per SM strides over the (d, g) items and reads w_hh from L2 instead,
// so any H runs.
// That grid is now the branch for the shapes that neither of the others
// holds: the cluster branch of fwd_cluster.cuh (a thread-block cluster per
// direction and 16 batch rows, the weights resident across it, h exchanged
// in distributed shared memory, one cluster barrier a step) takes every
// shape whose clusters all fit on the card at once (H <= 416: the recipe's
// B = 8 at H = 384, not B = 64 or 128, whose 8 or 16 clusters of 16 CTAs
// do not fit), and the wide branch of fwd_wide.cuh (one CTA an SM, the
// weights resident, 3xTF32 on the tensor cores, h exchanged through L2
// under per-block step flags) the rest up to its bound (H <= 600 at B =
// 128 with two directions, fwd_wide.cuh).  The grid's device code lives in lstm_fwd.cuh, which the
// training forward shares.

#include "fwd_cluster.cuh"

namespace {

// The eval forward's branch: the fp32-product cluster kernel (kRound =
// false: h enters the product in fp32) or the grid.
template <typename S>
cudaError_t eval_branch(int B, int H, int ndir, int* branch) {
  return fwd_branch<LstmCell, S, false>(B, H, ndir, branch);
}

}  // namespace

extern "C" {

// The forward's branch for this shape on the current device: *branch 0 the
// grid, 3 the fp32 cluster, 4 the wide branch (FwdBranch).  Returns a
// cudaError_t.
int lstm_bidir_fwd_branch(int B, int H, int ndir, int bf16, int* branch) {
  return (int)(bf16 ? eval_branch<__nv_bfloat16>(B, H, ndir, branch)
                    : eval_branch<float>(B, H, ndir, branch));
}

// gx (T, B, ndir * 4H) and ys (T, B, ndir * H) in the stream type (bf16 !=
// 0: bfloat16, else float32); w_hh (ndir, H, 4H) fp32; ndir 1 or 2.  The
// scratch, by branch (null for the clusters): the grid's hbuf (ndir, 2, H,
// ldh) with ldh >= B a multiple of 4, and cbuf (ndir, B, H), both fp32
// zeros; the wide branch's exchange buffer as hbuf (wide_hx_floats fp32)
// and its step flags as cbuf (wide_flag_ints int32, zeroed here).
// *branch: the branch launched, as lstm_bidir_fwd_branch numbers them.
// Returns a cudaError_t; 0 means launched.
int lstm_bidir_forward(const void* gx, const void* w_hh, void* ys, void* hbuf,
                       void* cbuf, int T, int B, int H, int ldh, int ndir,
                       int bf16, void* stream, int* branch) {
  *branch = -1;
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  int plan = 0;
  cudaError_t err = bf16 ? eval_branch<__nv_bfloat16>(B, H, ndir, &plan)
                         : eval_branch<float>(B, H, ndir, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan == kFwdGrid) {
    if (!hbuf || !cbuf) return (int)cudaErrorInvalidValue;
    err = bf16 ? launch<__nv_bfloat16, false>(gx, w_hh, ys, nullptr, hbuf,
                                               cbuf, T, B, H, ldh, ndir, st)
               : launch<float, false>(gx, w_hh, ys, nullptr, hbuf, cbuf, T, B,
                                      H, ldh, ndir, st);
  } else if (plan == kFwdWide) {
    err = bf16 ? launch_fwd_wide<LstmCell, __nv_bfloat16, false>(
                     gx, w_hh, ys, nullptr, hbuf, cbuf, T, B, H, ndir, st)
               : launch_fwd_wide<LstmCell, float, false>(
                     gx, w_hh, ys, nullptr, hbuf, cbuf, T, B, H, ndir, st);
  } else {
    err = bf16 ? launch_fwd_cluster<LstmCell, __nv_bfloat16, false>(
                     plan, gx, w_hh, ys, nullptr, T, B, H, ndir, st)
               : launch_fwd_cluster<LstmCell, float, false>(
                     plan, gx, w_hh, ys, nullptr, T, B, H, ndir, st);
  }
  if (err == cudaSuccess) *branch = plan;
  return (int)err;
}

const char* lstm_bidir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
