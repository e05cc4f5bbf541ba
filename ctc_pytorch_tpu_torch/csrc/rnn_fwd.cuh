// Device code and launcher of the tanh-RNN forward recurrence, built into
// rnn_bidir.cu, which serves eval and the training forward: the JAX
// package's eval and training forwards (ctc_pytorch_tpu/ops/rnn_pallas_v2.py
// _make_fwd_kernel, cell _rnn_cell2) differ only in the guard rows of the
// TPU's output plane (with_guard), and the cell saves nothing but ys.  The
// design notes are in rnn_bidir.cu.  rnn_bidir_train.cu (the backward)
// includes this file for rnn_product and rnn_load_weights: its recurrent
// product dh = dpre @ w_hh^T has the shape of the forward's h @ w_hh.
//
// The tile staging, cp.async helpers, round_to, the direction count ndir
// and the cooperative launcher come from lstm_fwd.cuh.

#pragma once

#include "lstm_fwd.cuh"

namespace {

// w_s[k * kUnits + u] = w(k, u0 + u) for k < H: w(k, n) = w[k * H + n], or
// w[n * H + k] with kTrans; zero past the last unit.
template <bool kTrans>
__device__ __forceinline__ void rnn_load_weights(float* w_s,
                                                 const float* __restrict__ w,
                                                 int u0, int H) {
  for (int idx = threadIdx.x; idx < H * kUnits; idx += 32 * kUnits) {
    const int k = idx / kUnits, un = u0 + idx % kUnits;
    float v = 0.f;
    if (un < H) v = kTrans ? w[(size_t)un * H + k] : w[(size_t)k * H + un];
    w_s[idx] = v;
  }
}

// acc[j] = sum_k src[k, b_j] * w(k, unit) over k < H, for the thread's rows
// b_j = r0 + rq * kRows + j and unit u0 + tid % kUnits.  src is (H, ldh),
// transposed, in global memory (L2); it is streamed through shared memory in
// k-tiles with cp.async, two tiles in flight.  w(k, unit) comes from w_s
// (rnn_load_weights) when kResident, else from w as rnn_load_weights reads it.
template <bool kResident, bool kTrans>
__device__ __forceinline__ void rnn_product(
    const float* src, const float* __restrict__ w, const float* w_s,
    float* tiles, float (&acc)[kRows], int r0, int u0, int B, int H,
    int ldh) {
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rq = tid / kUnits;  // row group, 0..31
  // past-the-end units read a valid weight; their sums are never stored
  const int unit_c = min(u0 + u, H - 1);
  const int n_tiles = (H + kTileK - 1) / kTileK;
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
  stage(tiles, src, 0, r0, H, ldh, tid);
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      stage(tiles + ((kt + 1) & 1) * kTileFloats, src, (kt + 1) * kTileK, r0,
            H, ldh, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, first, w_s) visible to all
    const float* tile = tiles + (kt & 1) * kTileFloats;
    const int k0 = kt * kTileK;
    // row groups wholly past B (small batches) skip the products
    const int kn = r0 + rq * kRows < B ? min(kTileK, H - k0) : 0;
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float wv;
      if constexpr (kResident) {
        wv = w_s[(size_t)(k0 + kk) * kUnits + u];
      } else {
        wv = kTrans ? w[(size_t)unit_c * H + k0 + kk]
                    : w[(size_t)(k0 + kk) * H + unit_c];
      }
      const float4 hv =
          *reinterpret_cast<const float4*>(tile + kk * kRowTile + rq * kRows);
      acc[0] = fmaf(hv.x, wv, acc[0]);
      acc[1] = fmaf(hv.y, wv, acc[1]);
      acc[2] = fmaf(hv.z, wv, acc[2]);
      acc[3] = fmaf(hv.w, wv, acc[3]);
    }
    __syncthreads();  // tile kt consumed before its buffer is refilled
  }
}

// One time step of work item (d, u0): h_t = tanh(gx_t + h_{t-1} @ w) for
// units [u0, u0 + kUnits) of direction d and every batch row.  h_prev is
// h_{t-1} as the stream type holds it, which is all the cell reads of it, so
// there is no fp32 carry; h_next gets h_t the same way.
template <typename S, bool kResident>
__device__ __forceinline__ void rnn_fwd_item(
    const S* __restrict__ gx, const float* __restrict__ w, const float* w_s,
    S* __restrict__ ys, const float* h_prev, float* h_next, float* tiles,
    int t, int u0, int d, int B, int H, int ldh, int ndir) {
  const int tid = threadIdx.x;
  const int unit = u0 + tid % kUnits;
  const int rq = tid / kUnits;
  const size_t row = (size_t)ndir * H;  // lanes of a batch row of gx and ys
  const size_t plane = (size_t)t * B * row + (size_t)d * H;
  for (int r0 = 0; r0 < B; r0 += kRowTile) {
    float acc[kRows];
    rnn_product<kResident, false>(h_prev, w, w_s, tiles, acc, r0, u0, B, H,
                                  ldh);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      if (unit >= H || b >= B) continue;
      const size_t o = plane + (size_t)b * row + unit;
      const float hn = tanhf(load_f(gx + o) + acc[j]);
      store_f(ys + o, hn);
      h_next[(size_t)unit * ldh + b] = round_to(hn, ys);
    }
  }
}

// Work item i = (direction i / groups, units from (i % groups) * kUnits),
// over ndir * groups items: one CTA per item with resident weights, or a
// smaller co-resident grid that strides over the items and reads the weights
// from L2.
template <typename S, bool kResident>
__global__ void __launch_bounds__(32 * kUnits)
    rnn_fwd_kernel(const S* __restrict__ gx, const float* __restrict__ w_hh,
                   S* __restrict__ ys, float* hbuf, int T, int B, int H,
                   int ldh, int ndir) {
  extern __shared__ float4 smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // kResident: [H][kUnits]
  // 32 * H bytes, so the tiles stay 16-byte aligned
  float* tiles = w_s + (kResident ? (size_t)H * kUnits : 0);  // [2][tile]

  const int groups = (H + kUnits - 1) / kUnits;
  const int items = ndir * groups;
  const size_t hh = (size_t)H * H;

  if constexpr (kResident)
    rnn_load_weights<false>(w_s, w_hh + (blockIdx.x / groups) * hh,
                            (blockIdx.x % groups) * kUnits, H);

  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < T; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int d = item / groups;
      float* hT = hbuf + (size_t)d * 2 * H * ldh;  // [2][H][ldh], zeroed
      rnn_fwd_item<S, kResident>(
          gx, w_hh + d * hh, w_s, ys, hT + (size_t)(s & 1) * H * ldh,
          hT + (size_t)((s + 1) & 1) * H * ldh, tiles,
          d == 0 ? s : T - 1 - s, (item % groups) * kUnits, d, B, H, ldh,
          ndir);
    }
    grid.sync();
  }
}

inline size_t rnn_smem_bytes(int H, bool resident) {
  return (resident ? (size_t)H * kUnits * sizeof(float) : 0) +
         2 * (size_t)kTileFloats * sizeof(float);
}

// Resident weights while the grid fits (see rnn_bidir.cu); past that the
// weights stay in L2.
template <typename S>
cudaError_t rnn_launch(const void* gx, const void* w_hh, void* ys, void* hbuf,
                       int T, int B, int H, int ldh, int ndir,
                       cudaStream_t stream) {
  void* args[] = {&gx, &w_hh, &ys, &hbuf, &T, &B, &H, &ldh, &ndir};
  const int items = ndir * ((H + kUnits - 1) / kUnits);
  int fits = 0;
  cudaError_t err = launch_cooperative(
      reinterpret_cast<const void*>(rnn_fwd_kernel<S, true>),
      rnn_smem_bytes(H, true), items, true, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  err = launch_cooperative(
      reinterpret_cast<const void*>(rnn_fwd_kernel<S, false>),
      rnn_smem_bytes(H, false), items, false, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace
