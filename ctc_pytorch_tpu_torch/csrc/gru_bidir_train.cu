// Trainable bidirectional GRU recurrence for Hopper (sm_90a): the backward
// kernel.
//
// Replaces the backward pallas_call of
// ctc_pytorch_tpu/ops/gru_pallas_v2.py:gru_scan_train_v2 (_bwd_pallas, kernel
// _make_bwd_kernel, un-hoisted step).  Its forward pallas_call (_fwd_pallas
// with_guard=True) is the eval kernel of gru_bidir.cu: a GRU saves nothing
// but ys, and the TPU kernel's guard rows are its own memory management.
//
// Backward: given gx (T, B, 6H), w_hh (2, H, 3H), ys and dy (T, B, 2H) in
// the stream type S, it walks direction 0 from t = T-1 down and direction 1
// from t = 0 up, and per step
// (a) recomputes hh = h_prev(t) @ w_hh and the gates r, z, n, where
//     h_prev(t) is a saved row of ys (t-1 for direction 0, t+1 for
//     direction 1, zero outside), so this product waits on no carry;
// (b) with dh_t = dy[t] + dh:
//       dpre_n = dh_t * (1 - z) * (1 - n^2)     dhh_n = dpre_n * r
//       dpre_r = dpre_n * hh_n * r * (1 - r)    dpre_z = dh_t * (h_prev - n) * z * (1 - z)
//     writes [dpre_r | dpre_z | dpre_n] to dgx[t] and dhh_n to dhhn[t], in S
//     (the n gate sees r * hh_n, so dW_hh's third block needs dhh_n, not
//     dpre_n);
// (c) dh = [dpre_r, dpre_z, dhh_n](as S) @ w_hh^T + dh_t * z.  The product
//     contracts over all 3H gate columns, so every CTA needs every CTA's
//     values of this step; dh_t * z is local to the unit's owner.
//
// What bounds it: as the forward, the serial chain of T steps with a
// grid-wide barrier each, fp32 products on CUDA cores.  The card's limits
// are far below: two (B, H) x (H, 3H)-sized products per step and direction,
// 19.1 GFLOP at T'=95, B=128, H=256, and gx, ys, dy in, dgx, dhhn out,
// ~113 MB with bf16 streams.  With bf16 streams every operand of the
// products is a bf16 value (tensor cores: ~0.019 ms), so the limit is the
// bytes, ~0.034 ms at 3.35 TB/s; with fp32 streams it is the fp32 operations
// at 67 TFLOP/s.
//
// Design: the LSTM backward's (lstm_bidir_train.cu).  CTA (d, g) owns 8
// hidden units of direction d; each thread owns one unit and 4 batch rows.
// Resident in shared memory: the unit's r, z, n columns of w_hh[d] (for a)
// and its row of 3H weights (for c).  Per step:
//   phase B  dh for the owned units: the product over the previous step's
//            [dpre_r, dpre_z, dhh_n], which all CTAs wrote transposed,
//            (3H, ldh), into a global double buffer (L2), streamed through
//            shared memory with cp.async; added to the dh_t * z that the
//            same thread left in its dh scratch;
//   phase A  hh: rows of ys staged through shared memory, product with the
//            resident columns, the three gates kept apart;
//   phase C  the gate backward, dgx, dhhn, the exchange write, dh_t * z;
//   grid.sync().
// The 3H contraction is padded to a multiple of 4 rows (zeros), so H need
// not be one.  With the weights resident a CTA needs about 224*H + 64 KB, so
// one CTA fits per SM and the 2*ceil(H/8) CTAs are co-resident while
// H <= 4 * SMs; past that a co-resident grid strides over the items and
// reads w_hh from L2.  dW_hh is formed outside from shifted ys against dgx
// and dhhn (plain GEMMs), as the JAX package does.

#include "gru_fwd.cuh"

namespace {

constexpr int kLdA = kTileK + 1;  // row stride of the phase-A tile (odd: no
                                  // bank conflicts across row groups)

// One backward time step of work item (d, u0) at forward time t.  K4 is 3H
// rounded up to a multiple of 4.
template <typename S, bool kResident>
__device__ __forceinline__ void gru_bwd_item(
    const S* __restrict__ gx, const float* __restrict__ w,
    const float4* wc_s, const float4* wr_s, const S* __restrict__ ys,
    const S* __restrict__ dy, S* __restrict__ dgx, S* __restrict__ dhhn,
    const float* dp_prev, float* dp_next, float* dh, float* tiles, int t,
    int t_prev, bool first, int u0, int d, int B, int H, int K4, int ldh,
    int ndir) {
  constexpr int kThreads = 32 * kUnits;
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rq = tid / kUnits;  // row group, 0..31
  const int unit = u0 + u;
  const bool unit_ok = unit < H;
  const int unit_c = min(unit, H - 1);
  const int H3 = 3 * H;
  const size_t h3 = 3 * (size_t)H;
  const bool has_prev = t_prev >= 0;
  const size_t row = (size_t)ndir * H;  // lanes of a batch row of ys
  const S* gx_t = gx + (size_t)t * B * ndir * h3 + d * h3;
  S* dgx_t = dgx + (size_t)t * B * ndir * h3 + d * h3;
  const size_t plane_t = (size_t)t * B * row + (size_t)d * H;
  const size_t plane_p = (size_t)(has_prev ? t_prev : 0) * B * row +
                         (size_t)d * H;

  for (int r0 = 0; r0 < B; r0 += kRowTile) {
    const bool rows_live = r0 + rq * kRows < B;

    // ---- phase B: dh[b, unit] += sum_col dhh_prev[col, b] * w[unit, col]
    if (!first) {
      const int n_tiles = (K4 + kTileK - 1) / kTileK;
      float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
      stage(tiles, dp_prev, 0, r0, K4, ldh, tid);
      for (int kt = 0; kt < n_tiles; ++kt) {
        if (kt + 1 < n_tiles) {
          stage(tiles + ((kt + 1) & 1) * kTileFloats, dp_prev,
                (kt + 1) * kTileK, r0, K4, ldh, tid);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* tile = tiles + (kt & 1) * kTileFloats;
        const int k0 = kt * kTileK;
        const int kn = rows_live ? min(kTileK, K4 - k0) : 0;  // multiple of 4
#pragma unroll 4
        for (int kk = 0; kk < kn; kk += 4) {
          float wk[4];
          if constexpr (kResident) {
            const float4 wv = wr_s[(size_t)((k0 + kk) / 4) * kUnits + u];
            wk[0] = wv.x, wk[1] = wv.y, wk[2] = wv.z, wk[3] = wv.w;
          } else {
            const float* row = w + (size_t)unit_c * h3;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              wk[q] = k0 + kk + q < H3 ? row[k0 + kk + q] : 0.f;
          }
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
        if (unit_ok && b < B) dh[(size_t)b * H + unit] += acc[j];
      }
    }

    // ---- phase A: hh = h_prev @ w[:, own columns], r, z and n apart
    float acc[kRows][3];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j][0] = acc[j][1] = acc[j][2] = 0.f;
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
            const float* row = w + (size_t)(k0 + kk) * h3 + unit_c;
            wv = make_float4(row[0], row[H], row[2 * H], 0.f);
          }
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float hv = trow[j * kLdA + kk];
            acc[j][0] = fmaf(hv, wv.x, acc[j][0]);
            acc[j][1] = fmaf(hv, wv.y, acc[j][1]);
            acc[j][2] = fmaf(hv, wv.z, acc[j][2]);
          }
        }
        __syncthreads();
      }
    }

    // ---- phase C: gate backward for the owned (row, unit) pairs
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      if (!unit_ok || b >= B) continue;
      const S* g = gx_t + (size_t)b * ndir * h3 + unit;
      const float hh_n = acc[j][2];
      const float rg = sigmoid_f(load_f(g) + acc[j][0]);
      const float zg = sigmoid_f(load_f(g + H) + acc[j][1]);
      const float ng = tanhf(load_f(g + 2 * H) + rg * hh_n);
      const size_t o_t = plane_t + (size_t)b * row + unit;
      const float hp =
          has_prev ? load_f(ys + plane_p + (size_t)b * row + unit) : 0.f;
      float* dhp = dh + (size_t)b * H + unit;
      const float dh_t = load_f(dy + o_t) + *dhp;
      const float dz = dh_t * (hp - ng);
      const float dn = dh_t * (1.0f - zg);
      const float dpre_n = dn * (1.0f - ng * ng);
      const float dr = dpre_n * hh_n;
      const float dpre_r = dr * rg * (1.0f - rg);
      const float dpre_z = dz * zg * (1.0f - zg);
      const float dhh_n = dpre_n * rg;
      *dhp = dh_t * zg;
      S* out = dgx_t + (size_t)b * ndir * h3 + unit;
      store_f(out, dpre_r);
      store_f(out + H, dpre_z);
      store_f(out + 2 * H, dpre_n);
      store_f(dhhn + o_t, dhh_n);
      dp_next[(size_t)unit * ldh + b] = round_to(dpre_r, out);
      dp_next[(size_t)(H + unit) * ldh + b] = round_to(dpre_z, out);
      dp_next[(size_t)(2 * H + unit) * ldh + b] = round_to(dhh_n, out);
    }
  }
}

template <typename S, bool kResident>
__global__ void __launch_bounds__(32 * kUnits)
    gru_bidir_bwd_kernel(const S* __restrict__ gx,
                         const float* __restrict__ w_hh,
                         const S* __restrict__ ys, const S* __restrict__ dy,
                         S* __restrict__ dgx, S* __restrict__ dhhn,
                         float* dpbuf, float* dhbuf, int T, int B, int H,
                         int ldh, int ndir) {
  extern __shared__ float4 smem[];
  // kResident: wc_s [H][kUnits] (r, z, n, 0) per unit; wr_s [K4/4][kUnits],
  // four consecutive gate columns of the unit's row per entry
  const int H3 = 3 * H;
  const int K4 = (H3 + 3) / 4 * 4;
  float4* wc_s = smem;
  float4* wr_s = smem + (kResident ? (size_t)H * kUnits : 0);
  float* tiles = reinterpret_cast<float*>(
      smem + (kResident ? (size_t)(H + K4 / 4) * kUnits : 0));  // [2][tile]

  const int groups = (H + kUnits - 1) / kUnits;
  const int items = ndir * groups;
  const size_t h3 = 3 * (size_t)H;

  if constexpr (kResident) {
    const int d = blockIdx.x / groups;
    const int u0 = (blockIdx.x % groups) * kUnits;
    const float* w = w_hh + (size_t)d * H * h3;
    for (int idx = threadIdx.x; idx < H * kUnits; idx += 32 * kUnits) {
      const int k = idx / kUnits, un = u0 + idx % kUnits;
      float4 vc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (un < H) {
        const float* col = w + (size_t)k * h3 + un;
        vc = make_float4(col[0], col[H], col[2 * H], 0.f);
      }
      wc_s[idx] = vc;
    }
    for (int idx = threadIdx.x; idx < (K4 / 4) * kUnits; idx += 32 * kUnits) {
      const int k = 4 * (idx / kUnits), un = u0 + idx % kUnits;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (un < H) {
        const float* row = w + (size_t)un * h3;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < H3) v[q] = row[k + q];
      }
      wr_s[idx] = make_float4(v[0], v[1], v[2], v[3]);
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
      float* dp = dpbuf + (size_t)d * 2 * K4 * ldh;  // [2][K4][ldh], zeroed
      gru_bwd_item<S, kResident>(
          gx, w_hh + (size_t)d * H * h3, wc_s, wr_s, ys, dy, dgx, dhhn,
          dp + (size_t)((s + 1) & 1) * K4 * ldh,
          dp + (size_t)(s & 1) * K4 * ldh, dhbuf + (size_t)d * B * H, tiles,
          t, t_prev, s == 0, u0, d, B, H, K4, ldh, ndir);
    }
    grid.sync();
  }
}

size_t gru_bwd_smem_bytes(int H, bool resident) {
  const size_t k4 = (3 * (size_t)H + 3) / 4 * 4;
  return (resident ? ((size_t)H + k4 / 4) * kUnits * sizeof(float4) : 0) +
         2 * (size_t)kTileFloats * sizeof(float);
}

template <typename S>
cudaError_t gru_launch_bwd(const void* gx, const void* w_hh, const void* ys,
                           const void* dy, void* dgx, void* dhhn, void* dpbuf,
                           void* dhbuf, int T, int B, int H, int ldh,
                           int ndir, cudaStream_t stream) {
  void* args[] = {&gx,    &w_hh,  &ys, &dy, &dgx, &dhhn,
                  &dpbuf, &dhbuf, &T,  &B,  &H,   &ldh, &ndir};
  const int items = ndir * ((H + kUnits - 1) / kUnits);
  int fits = 0;
  cudaError_t err = launch_cooperative(
      reinterpret_cast<const void*>(gru_bidir_bwd_kernel<S, true>),
      gru_bwd_smem_bytes(H, true), items, true, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  err = launch_cooperative(
      reinterpret_cast<const void*>(gru_bidir_bwd_kernel<S, false>),
      gru_bwd_smem_bytes(H, false), items, false, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

extern "C" {

// gx, dgx (T, B, ndir * 3H) and ys, dy, dhhn (T, B, ndir * H) in the stream
// type; w_hh (ndir, H, 3H) fp32, rounded to the stream type by the caller;
// dpbuf (ndir, 2, K4, ldh) with K4 = 3H rounded up to a multiple of 4 and
// ldh >= B a multiple of 4, and dhbuf (ndir, B, H), both fp32 zeros; ndir 1
// or 2.  Returns a cudaError_t; 0 means launched.
int gru_bidir_train_backward(const void* gx, const void* w_hh, const void* ys,
                             const void* dy, void* dgx, void* dhhn,
                             void* dpbuf, void* dhbuf, int T, int B, int H,
                             int ldh, int ndir, int bf16, void* stream) {
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)gru_launch_bwd<__nv_bfloat16>(
        gx, w_hh, ys, dy, dgx, dhhn, dpbuf, dhbuf, T, B, H, ldh, ndir, st);
  return (int)gru_launch_bwd<float>(gx, w_hh, ys, dy, dgx, dhhn, dpbuf, dhbuf,
                                    T, B, H, ldh, ndir, st);
}

const char* gru_bidir_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
