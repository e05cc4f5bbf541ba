// Trainable bidirectional LSTM recurrence for Hopper (sm_90a): a forward
// kernel that keeps what the backward needs, and the backward kernel.
//
// Replaces ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py: the forward
// pallas_call (_fwd_pallas, kernel _make_fwd_kernel) and the backward
// pallas_call (_bwd_pallas, kernel _make_bwd_kernel, un-hoisted step).
//
// Forward: lstm_fwd.cuh with kTrain = true.  gx (T, B, 8H) in the stream
// type S, w_hh (2, H, 4H) fp32 (already rounded to S by the caller) ->
// ys (T, B, 2H) and the cell states cs (T, B, 2H), both in S.  The carries
// are fp32; with bf16 streams h enters the next step's product as ys holds
// it.  Same design as the eval kernel (lstm_bidir.cu), plus one more
// (T, B, 2H) plane written.
//
// Backward: given gx, w_hh, ys, cs and dy (T, B, 2H) in S, it walks
// direction 0 from t = T-1 down and direction 1 from t = 0 up, and per step
// (a) recomputes the gate pre-activations gx[t] + h_prev(t) @ w_hh, where
//     h_prev(t) is a saved row of ys (t-1 for direction 0, t+1 for
//     direction 1, zero outside), so this product waits on no carry;
// (b) forms dpre (order i, f, g, o) from the carries (dh, dc), dy[t], cs and
//     the gates, writes it to dgx[t] in S;
// (c) dh_prev = dpre(as S) @ w_hh^T, which contracts over all 4H gate
//     columns, so every CTA needs every CTA's dpre of this step.
//
// What bounds it: the T steps are a serial chain with a grid-wide barrier
// each, and the products run in fp32 on CUDA cores.  The card's own limits
// are far below that.  The backward does two (B, H) x (H, 4H)-sized products
// per step and direction, 48.3 GFLOP at T=80, B=128, H=384 (the forward one,
// 24.2 GFLOP), and moves gx, ys, cs, dy in and dgx out.  With bf16 streams
// every operand of those products is a bf16 value, which the tensor cores
// multiply at 989 TFLOP/s (~0.05 ms), so the limit is the bytes: ~0.18 GB,
// ~0.053 ms at 3.35 TB/s (forward ~0.10 GB, ~0.030 ms).  With fp32 streams
// the products are fp32 and the limit is operations at 67 TFLOP/s.
//
// Design: one persistent cooperative grid, as the forward.  CTA (d, g) owns
// 8 hidden units of direction d; each thread owns one unit and 4 batch rows.
// Resident in shared memory for the whole run: the unit's 32 gate columns
// of w_hh[d] (for a) and its 8 rows (for c), 256*H bytes together.  Per step:
//   phase B  dh for the owned units from the previous step's dpre, which
//            all CTAs wrote transposed, (4H, ldh), into a global double
//            buffer (L2); streamed through shared memory in k-tiles with
//            cp.async as the forward streams h;
//   phase A  the gates: rows of ys staged through shared memory, product
//            with the resident columns;
//   phase C  the cell backward, dgx and the dpre exchange write;
//   grid.sync().
// dh and dc live in global scratch that only the owning thread touches.
// With the weights resident a CTA needs 256*H + 64 KB, so one CTA fits per
// SM and the 2*ceil(H/8) CTAs are co-resident while H <= 4 * SMs (528 on a
// 132-SM H100); past that a co-resident grid strides over the (d, g) items
// and reads w_hh from L2, so any H runs.  dW_hh is formed outside from
// shifted ys against dgx (two plain GEMMs), as the JAX package does.
// Tensor cores, hoisting (a) off the serial chain and TMA are later work.

#include "lstm_fwd.cuh"

namespace {

constexpr int kLdA = kTileK + 1;  // row stride of the phase-A tile (odd: no
                                  // bank conflicts across row groups)

// One backward time step of work item (d, u0) at forward time t.
template <typename S, bool kResident>
__device__ __forceinline__ void bwd_item(
    const S* __restrict__ gx, const float* __restrict__ w,
    const float4* wc_s, const float4* wr_s, const S* __restrict__ ys,
    const S* __restrict__ cs, const S* __restrict__ dy, S* __restrict__ dgx,
    const float* dp_prev, float* dp_next, float* dh, float* dc, float* tiles,
    int t, int t_prev, bool first, int u0, int d, int B, int H, int ldh,
    int ndir) {
  constexpr int kThreads = 32 * kUnits;
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rq = tid / kUnits;  // row group, 0..31
  const int unit = u0 + u;
  const bool unit_ok = unit < H;
  const int unit_c = min(unit, H - 1);
  const int H4 = 4 * H;
  const size_t h4 = 4 * (size_t)H;
  const bool has_prev = t_prev >= 0;
  const size_t row = (size_t)ndir * H;  // lanes of a batch row of ys
  const S* gx_t = gx + (size_t)t * B * ndir * h4 + d * h4;
  S* dgx_t = dgx + (size_t)t * B * ndir * h4 + d * h4;
  const size_t plane_t = (size_t)t * B * row + (size_t)d * H;
  const size_t plane_p = (size_t)(has_prev ? t_prev : 0) * B * row +
                         (size_t)d * H;

  for (int r0 = 0; r0 < B; r0 += kRowTile) {
    const bool rows_live = r0 + rq * kRows < B;

    // ---- phase B: dh[b, unit] = sum_col dpre_prev[col, b] * w[unit, col]
    if (!first) {
      const int n_tiles = (H4 + kTileK - 1) / kTileK;
      float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
      stage(tiles, dp_prev, 0, r0, H4, ldh, tid);
      for (int kt = 0; kt < n_tiles; ++kt) {
        if (kt + 1 < n_tiles) {
          stage(tiles + ((kt + 1) & 1) * kTileFloats, dp_prev,
                (kt + 1) * kTileK, r0, H4, ldh, tid);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* tile = tiles + (kt & 1) * kTileFloats;
        const int k0 = kt * kTileK;
        const int kn = rows_live ? min(kTileK, H4 - k0) : 0;  // multiple of 4
#pragma unroll 4
        for (int kk = 0; kk < kn; kk += 4) {
          float4 wv;
          if constexpr (kResident) {
            wv = wr_s[(size_t)((k0 + kk) / 4) * kUnits + u];
          } else {
            wv = *reinterpret_cast<const float4*>(w + (size_t)unit_c * h4 +
                                                  k0 + kk);
          }
          const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 dv = *reinterpret_cast<const float4*>(
                tile + (kk + q) * kRowTile + rq * kRows);
            acc[0] = fmaf(dv.x, wk[q], acc[0]);
            acc[1] = fmaf(dv.y, wk[q], acc[1]);
            acc[2] = fmaf(dv.z, wk[q], acc[2]);
            acc[3] = fmaf(dv.w, wk[q], acc[3]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int b = r0 + rq * kRows + j;
        if (unit_ok && b < B) dh[(size_t)b * H + unit] = acc[j];
      }
    }

    // ---- phase A: gates = gx[t] + h_prev @ w[:, own columns]
    float acc[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      const bool ok = unit_ok && b < B;
      const S* g = gx_t + (size_t)b * ndir * h4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = ok ? load_f(g + q * H) : 0.f;
    }
    if (has_prev) {
      const int n_tiles = (H + kTileK - 1) / kTileK;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * kTileK;
        // rows [r0, r0 + 128) x k [k0, k0 + 64) of ys[t_prev] -> tiles
        for (int e = tid; e < kRowTile * kTileK; e += kThreads) {
          const int r = e / kTileK, kk = e % kTileK;
          const int b = r0 + r, k = k0 + kk;
          tiles[r * kLdA + kk] =
              (b < B && k < H)
                  ? load_f(ys + plane_p + (size_t)b * row + k)
                  : 0.f;
        }
        __syncthreads();
        const int kn = rows_live ? min(kTileK, H - k0) : 0;
        const float* trow = tiles + (rq * kRows) * kLdA;
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          float4 wv;
          if constexpr (kResident) {
            wv = wc_s[(size_t)(k0 + kk) * kUnits + u];
          } else {
            const float* row = w + (size_t)(k0 + kk) * h4 + unit_c;
            wv = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
          }
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float hv = trow[j * kLdA + kk];
            acc[j][0] = fmaf(hv, wv.x, acc[j][0]);
            acc[j][1] = fmaf(hv, wv.y, acc[j][1]);
            acc[j][2] = fmaf(hv, wv.z, acc[j][2]);
            acc[j][3] = fmaf(hv, wv.w, acc[j][3]);
          }
        }
        __syncthreads();
      }
    }

    // ---- phase C: cell backward for the owned (row, unit) pairs
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      if (!unit_ok || b >= B) continue;
      const float ig = sigmoid_f(acc[j][0]);
      const float fg = sigmoid_f(acc[j][1]);
      const float gg = tanhf(acc[j][2]);
      const float og = sigmoid_f(acc[j][3]);
      const size_t o_t = plane_t + (size_t)b * row + unit;
      const float c_t = load_f(cs + o_t);
      const float c_prev =
          has_prev ? load_f(cs + plane_p + (size_t)b * row + unit) : 0.f;
      const float tc = tanhf(c_t);
      float* dhp = dh + (size_t)b * H + unit;
      float* dcp = dc + (size_t)b * H + unit;
      const float dh_t = load_f(dy + o_t) + *dhp;
      const float d_o = dh_t * tc;
      const float dct = *dcp + dh_t * og * (1.0f - tc * tc);
      const float dpre[4] = {
          dct * gg * (ig * (1.0f - ig)),
          dct * c_prev * (fg * (1.0f - fg)),
          dct * ig * (1.0f - gg * gg),
          d_o * (og * (1.0f - og)),
      };
      *dcp = dct * fg;
      S* out = dgx_t + (size_t)b * ndir * h4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        store_f(out + q * H, dpre[q]);
        dp_next[(size_t)(q * H + unit) * ldh + b] = round_to(dpre[q], out);
      }
    }
  }
}

template <typename S, bool kResident>
__global__ void __launch_bounds__(32 * kUnits)
    lstm_bidir_bwd_kernel(const S* __restrict__ gx,
                          const float* __restrict__ w_hh,
                          const S* __restrict__ ys, const S* __restrict__ cs,
                          const S* __restrict__ dy, S* __restrict__ dgx,
                          float* dpbuf, float* dhbuf, float* dcbuf, int T,
                          int B, int H, int ldh, int ndir) {
  extern __shared__ float4 smem[];
  // kResident: wc_s [H][kUnits] (i, f, g, o) per unit; wr_s [H][kUnits],
  // four consecutive gate columns of the unit's row per entry
  float4* wc_s = smem;
  float4* wr_s = smem + (kResident ? (size_t)H * kUnits : 0);
  float* tiles = reinterpret_cast<float*>(
      smem + (kResident ? 2 * (size_t)H * kUnits : 0));  // [2][kTileFloats]

  const int groups = (H + kUnits - 1) / kUnits;
  const int items = ndir * groups;
  const size_t h4 = 4 * (size_t)H;

  if constexpr (kResident) {
    const int d = blockIdx.x / groups;
    const int u0 = (blockIdx.x % groups) * kUnits;
    const float* w = w_hh + (size_t)d * H * h4;
    for (int idx = threadIdx.x; idx < H * kUnits; idx += 32 * kUnits) {
      const int k = idx / kUnits, un = u0 + idx % kUnits;
      float4 vc = make_float4(0.f, 0.f, 0.f, 0.f), vr = vc;
      if (un < H) {
        const float* col = w + (size_t)k * h4 + un;
        vc = make_float4(col[0], col[H], col[2 * H], col[3 * H]);
        vr = *reinterpret_cast<const float4*>(w + (size_t)un * h4 + 4 * k);
      }
      wc_s[idx] = vc;
      wr_s[idx] = vr;
    }
  }

  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < T; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int d = item / groups;
      const int u0 = (item % groups) * kUnits;
      const int t = d == 0 ? T - 1 - s : s;
      int t_prev = d == 0 ? t - 1 : t + 1;
      if (t_prev >= T) t_prev = -1;
      float* dp = dpbuf + (size_t)d * 2 * h4 * ldh;  // [2][4H][ldh]
      bwd_item<S, kResident>(
          gx, w_hh + (size_t)d * H * h4, wc_s, wr_s, ys, cs, dy, dgx,
          dp + (size_t)((s + 1) & 1) * h4 * ldh, dp + (size_t)(s & 1) * h4 * ldh,
          dhbuf + (size_t)d * B * H, dcbuf + (size_t)d * B * H, tiles, t,
          t_prev, s == 0, u0, d, B, H, ldh, ndir);
    }
    grid.sync();
  }
}

size_t bwd_smem_bytes(int H, bool resident) {
  return (resident ? 2 * (size_t)H * kUnits * sizeof(float4) : 0) +
         2 * (size_t)kTileFloats * sizeof(float);
}

template <typename S>
cudaError_t launch_bwd(const void* gx, const void* w_hh, const void* ys,
                       const void* cs, const void* dy, void* dgx, void* dpbuf,
                       void* dhbuf, void* dcbuf, int T, int B, int H, int ldh,
                       int ndir, cudaStream_t stream) {
  void* args[] = {&gx,    &w_hh,  &ys, &cs, &dy, &dgx,  &dpbuf,
                  &dhbuf, &dcbuf, &T,  &B,  &H,  &ldh, &ndir};
  const int items = ndir * ((H + kUnits - 1) / kUnits);
  int fits = 0;
  cudaError_t err = launch_cooperative(
      reinterpret_cast<const void*>(lstm_bidir_bwd_kernel<S, true>),
      bwd_smem_bytes(H, true), items, true, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  err = launch_cooperative(
      reinterpret_cast<const void*>(lstm_bidir_bwd_kernel<S, false>),
      bwd_smem_bytes(H, false), items, false, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

extern "C" {

// Forward.  gx (T, B, ndir * 4H), ys and cs (T, B, ndir * H) in the stream
// type (bf16 != 0: bfloat16, else float32); w_hh (ndir, H, 4H) fp32; hbuf
// (ndir, 2, H, ldh) with ldh >= B a multiple of 4, and cbuf (ndir, B, H),
// both fp32 zeros; ndir 1 or 2.  Returns a cudaError_t; 0 means launched.
int lstm_bidir_train_forward(const void* gx, const void* w_hh, void* ys,
                             void* cs, void* hbuf, void* cbuf, int T, int B,
                             int H, int ldh, int ndir, int bf16,
                             void* stream) {
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch<__nv_bfloat16, true>(gx, w_hh, ys, cs, hbuf, cbuf, T, B,
                                            H, ldh, ndir, st);
  return (int)launch<float, true>(gx, w_hh, ys, cs, hbuf, cbuf, T, B, H, ldh,
                                  ndir, st);
}

// Backward.  gx, dgx (T, B, ndir * 4H) and ys, cs, dy (T, B, ndir * H) in
// the stream type; w_hh as above; dpbuf (ndir, 2, 4H, ldh), dhbuf and dcbuf
// (ndir, B, H) fp32 zeros.  Returns a cudaError_t; 0 means launched.
int lstm_bidir_train_backward(const void* gx, const void* w_hh, const void* ys,
                              const void* cs, const void* dy, void* dgx,
                              void* dpbuf, void* dhbuf, void* dcbuf, int T,
                              int B, int H, int ldh, int ndir, int bf16,
                              void* stream) {
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_bwd<__nv_bfloat16>(gx, w_hh, ys, cs, dy, dgx, dpbuf,
                                          dhbuf, dcbuf, T, B, H, ldh, ndir, st);
  return (int)launch_bwd<float>(gx, w_hh, ys, cs, dy, dgx, dpbuf, dhbuf, dcbuf,
                                T, B, H, ldh, ndir, st);
}

const char* lstm_bidir_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
