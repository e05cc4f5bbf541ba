// Device code and launcher of the bidirectional GRU forward recurrence,
// built into gru_bidir.cu, which serves eval and the training forward.  The
// two are the same function: the JAX package's eval and training forwards
// (ctc_pytorch_tpu/ops/gru_pallas_v2.py _make_fwd_kernel, cell _gru_cell2)
// differ only in the guard rows of the TPU's output plane, and a GRU has no
// cell state to save, so there is no eval/train switch here.  The design
// notes are in gru_bidir.cu.
//
// The tile staging, cp.async helpers, round_to and the cooperative launcher
// come from lstm_fwd.cuh, and so does the direction count ndir.

#pragma once

#include "lstm_fwd.cuh"

namespace {

// One time step of work item (d, u0): the r, z and n gates of units
// [u0, u0 + kUnits) of direction d for every batch row.  w_s holds those
// units' weights, (r, z, n, unused) per (k, unit), when they are resident in
// shared memory; otherwise they come from w (L2).  The three products stay
// apart until r is known: n = tanh(gx_n + r * (h W_n)).  hc is the fp32
// carry, which only the owning thread touches; h_next gets h_t as the stream
// type holds it, which is what the next step's product reads.
template <typename S, bool kResident>
__device__ __forceinline__ void gru_step_item(
    const S* __restrict__ gx, const float* __restrict__ w, const float4* w_s,
    S* __restrict__ ys, const float* h_prev, float* h_next, float* hc,
    float* tiles, int t, int u0, int d, int B, int H, int ldh, int ndir) {
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rq = tid / kUnits;  // row group, 0..31
  const int unit = u0 + u;
  const bool unit_ok = unit < H;
  const size_t h3 = 3 * (size_t)H;
  const int n_tiles = (H + kTileK - 1) / kTileK;
  // past-the-end units read a valid column and store nothing
  const float* w_col = w + min(unit, H - 1);
  const S* gx_t = gx + (size_t)t * B * ndir * h3 + d * h3;
  S* ys_t = ys + (size_t)t * B * ndir * H + (size_t)d * H;

  for (int r0 = 0; r0 < B; r0 += kRowTile) {
    stage(tiles, h_prev, 0, r0, H, ldh, tid);
    float acc[kRows][3];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      if (kt + 1 < n_tiles) {
        stage(tiles + ((kt + 1) & 1) * kTileFloats, h_prev, (kt + 1) * kTileK,
              r0, H, ldh, tid);
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
        float4 wv;
        if constexpr (kResident) {
          wv = w_s[(size_t)(k0 + kk) * kUnits + u];
        } else {
          const float* row = w_col + (size_t)(k0 + kk) * h3;
          wv = make_float4(row[0], row[H], row[2 * H], 0.f);
        }
        const float4 hv =
            *reinterpret_cast<const float4*>(tile + kk * kRowTile + rq * kRows);
        const float hr[kRows] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          acc[j][0] = fmaf(hr[j], wv.x, acc[j][0]);
          acc[j][1] = fmaf(hr[j], wv.y, acc[j][1]);
          acc[j][2] = fmaf(hr[j], wv.z, acc[j][2]);
        }
      }
      __syncthreads();  // tile kt consumed before its buffer is refilled
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      if (!unit_ok || b >= B) continue;
      const S* g = gx_t + (size_t)b * ndir * h3 + unit;
      const float rg = sigmoid_f(load_f(g) + acc[j][0]);
      const float zg = sigmoid_f(load_f(g + H) + acc[j][1]);
      const float ng = tanhf(load_f(g + 2 * H) + rg * acc[j][2]);
      float* hp = hc + (size_t)b * H + unit;
      const float hn = (1.0f - zg) * ng + zg * *hp;
      *hp = hn;
      S* y = ys_t + (size_t)b * ndir * H + unit;
      store_f(y, hn);
      h_next[(size_t)unit * ldh + b] = round_to(hn, y);
    }
  }
}

// Work item i = (direction i / groups, units from (i % groups) * kUnits), as
// in lstm_bidir_kernel: one CTA per item with resident weights, or a smaller
// co-resident grid that strides over the items and reads the weights from L2.
template <typename S, bool kResident>
__global__ void __launch_bounds__(32 * kUnits)
    gru_bidir_kernel(const S* __restrict__ gx, const float* __restrict__ w_hh,
                     S* __restrict__ ys, float* hbuf, float* hcarry, int T,
                     int B, int H, int ldh, int ndir) {
  extern __shared__ float4 smem[];
  float4* w_s = smem;  // kResident: [H][kUnits], (r, z, n, 0) per unit
  float* tiles = reinterpret_cast<float*>(
      smem + (kResident ? (size_t)H * kUnits : 0));  // [2][kTileFloats]

  const int groups = (H + kUnits - 1) / kUnits;
  const int items = ndir * groups;
  const size_t h3 = 3 * (size_t)H;

  if constexpr (kResident) {
    const int d = blockIdx.x / groups;
    const int u0 = (blockIdx.x % groups) * kUnits;
    const float* w = w_hh + (size_t)d * H * h3;
    for (int idx = threadIdx.x; idx < H * kUnits; idx += 32 * kUnits) {
      const int k = idx / kUnits, un = u0 + idx % kUnits;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (un < H) {
        const float* row = w + (size_t)k * h3 + un;
        v = make_float4(row[0], row[H], row[2 * H], 0.f);
      }
      w_s[idx] = v;
    }
  }

  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < T; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int d = item / groups;
      const int u0 = (item % groups) * kUnits;
      float* hT = hbuf + (size_t)d * 2 * H * ldh;  // [2][H][ldh], zeroed
      gru_step_item<S, kResident>(
          gx, w_hh + (size_t)d * H * h3, w_s, ys,
          hT + (size_t)(s & 1) * H * ldh, hT + (size_t)((s + 1) & 1) * H * ldh,
          hcarry + (size_t)d * B * H,  // [B][H], zeroed by the caller
          tiles, d == 0 ? s : T - 1 - s, u0, d, B, H, ldh, ndir);
    }
    grid.sync();
  }
}

// Resident weights while the grid fits (the bound of lstm_bidir.cu: the
// shared memory per CTA is the same, a float4 per (k, unit)); past that the
// weights stay in L2.
template <typename S>
cudaError_t gru_launch(const void* gx, const void* w_hh, void* ys, void* hbuf,
                       void* hcarry, int T, int B, int H, int ldh, int ndir,
                       cudaStream_t stream) {
  void* args[] = {&gx, &w_hh, &ys, &hbuf, &hcarry, &T, &B, &H, &ldh, &ndir};
  const int items = ndir * ((H + kUnits - 1) / kUnits);
  int fits = 0;
  cudaError_t err = launch_cooperative(
      reinterpret_cast<const void*>(gru_bidir_kernel<S, true>),
      smem_bytes(H, true), items, true, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  err = launch_cooperative(
      reinterpret_cast<const void*>(gru_bidir_kernel<S, false>),
      smem_bytes(H, false), items, false, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

// gx (T, B, ndir * 3H) and ys (T, B, ndir * H) in the stream type (bf16 !=
// 0: bfloat16, else float32); w_hh (ndir, H, 3H) fp32, already rounded to
// the stream type by the caller; hbuf (ndir, 2, H, ldh) with ldh >= B a
// multiple of 4, and hcarry (ndir, B, H), both fp32 zeros; ndir 1 or 2.
inline cudaError_t gru_forward(const void* gx, const void* w_hh, void* ys,
                               void* hbuf, void* hcarry, int T, int B, int H,
                               int ldh, int ndir, int bf16, void* stream) {
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return gru_launch<__nv_bfloat16>(gx, w_hh, ys, hbuf, hcarry, T, B, H, ldh,
                                     ndir, st);
  return gru_launch<float>(gx, w_hh, ys, hbuf, hcarry, T, B, H, ldh, ndir, st);
}

}  // namespace
