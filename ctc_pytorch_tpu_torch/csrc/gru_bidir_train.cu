// Trainable bidirectional GRU recurrence for Hopper (sm_90a): the
// backward's gate pre-pass and serial chain.
//
// Replaces the backward pallas_call of
// ctc_pytorch_tpu/ops/gru_pallas_v2.py:gru_scan_train_v2 (_bwd_pallas, kernel
// _make_bwd_kernel, the hoisted form: its pre-pass and step).  Its forward
// pallas_call (_fwd_pallas with_guard=True) is the eval kernel of
// gru_bidir.cu: a GRU saves nothing but ys, and the TPU kernel's guard rows
// are its own memory management.
//
// Backward, given gx (T, B, 6H), w_hh (2, H, 3H), ys and dy (T, B, 2H) in
// the stream type S, in two launches; bwd_hoist.cuh holds the design notes
// and the two kernels shared with the LSTM.
// (a) The pre-pass (gru_bidir_train_bwd_prepass): hh = h_prev(t) @ w_hh and
//     the gates r, z, n for every (t, b, direction) at once, h_prev(t) the
//     saved row of ys (t-1 for direction 0, t+1 for direction 1, zero
//     outside), folded into five fp32 planes [P_r | P_z | P_n | P_hn | Z]
//     (ndir, T, 5, B, Hp):  p_n = (1 - z)(1 - n^2),  P_r = p_n hh_n r(1 - r),
//     P_z = (h_prev - n) z(1 - z),  P_n = p_n,  P_hn = p_n r,  Z = z.
// (b) The serial chain (gru_bidir_train_backward): direction 0 from t = T-1
//     down, direction 1 from t = 0 up; per step, with dh_t = dy[t] + dh:
//     [dpre_r | dpre_z | dpre_n] = dh_t [P_r, P_z, P_n] -> dgx[t] in S,
//     dhh_n = dh_t P_hn -> dhhn[t] in S (the n gate sees r * hh_n, so dW_hh's
//     third block needs dhh_n, not dpre_n),
//     dh = [dpre_r, dpre_z, dhh_n](as S) @ w_hh^T + dh_t Z.  The product
//     contracts over all 3H gate columns, so the CTAs of a batch row
//     exchange it; dh_t Z is local to the unit's owner.
//
// What bounds it: the serial chain of T steps; the card's limits are far
// below.  Two (B, H) x (H, 3H)-sized products per step and direction, 19.1
// GFLOP at T'=95, B=128, H=256, and gx, ys, dy in, dgx, dhhn out, ~113 MB
// with bf16 streams.  With bf16 streams every operand of the products is a
// bf16 value (tensor cores: ~0.019 ms), so the limit is the bytes, ~0.034
// ms at 3.35 TB/s (the planes add 125 MB written and read once); with fp32
// streams it is the fp32 operations at 67 TFLOP/s.
//
// Four branches for (b), chosen by the launcher, which reports the one it
// took: the two cluster branches of bwd_hoist.cuh, bwd_cluster_kernel (bf16
// streams, H <= 480) and bwd_fma_kernel (fp32 streams: 16 rows a cluster of
// 8 CTAs to H = 344, of 16 to H = 500, where all the clusters fit at once:
// B = 8 at H = 256, not B = 128), the wide branch of bwd_wide.cuh for fp32
// streams where those clusters do not all fit (B = 128 at H = 256: one
// persistent CTA an SM, 3xTF32 on the tensor cores, the partial dh through
// L2 under step flags), and for every other shape the grid branch below,
// the LSTM's
// (lstm_bidir_train.cu): one persistent cooperative grid, CTA (d, g) owning
// 8 hidden units of direction d, each thread one unit and 4 batch rows, the
// unit's row of 3H weights resident in shared memory.  Per step:
//   phase B  dh for the owned units: the product over the previous step's
//            [dpre_r, dpre_z, dhh_n], which all CTAs wrote transposed,
//            (3H, ldh), into a global double buffer (L2), streamed through
//            shared memory with cp.async; added to the dh_t Z that the same
//            thread left in its dh scratch;
//   phase C  the gate backward from the planes, dgx, dhhn, the exchange
//            write, dh_t Z;
//   grid.sync().
// The 3H contraction is padded to a multiple of 4 rows (zeros), so H need
// not be one.  With the weights resident a CTA needs about 96*H + 64 KB, so
// the 2*ceil(H/8) CTAs are co-resident while H <= 4 * SMs; past that a
// co-resident grid strides over the items and reads w_hh from L2.  dW_hh
// is formed outside from shifted ys against dgx and dhhn (plain GEMMs), as
// the JAX package does.

#include "gru_fwd.cuh"
#include "bwd_hoist.cuh"

namespace {

// One backward step of work item (d, u0) at forward time t (grid branch).
// K4 is 3H rounded up to a multiple of 4.
template <typename S, bool kResident>
__device__ __forceinline__ void gru_bwd_item(
    const float* __restrict__ planes, const float* __restrict__ w,
    const float4* wr_s, const S* __restrict__ dy, S* __restrict__ dgx,
    S* __restrict__ dhhn, const float* dp_prev, float* dp_next, float* dh,
    float* tiles, int t, bool first, int u0, int d, int T, int B, int H,
    int Hp, int K4, int ldh, int ndir) {
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rq = tid / kUnits;  // row group, 0..31
  const int unit = u0 + u;
  const bool unit_ok = unit < H;
  const int unit_c = min(unit, H - 1);
  const int H3 = 3 * H;
  const size_t h3 = 3 * (size_t)H;
  const size_t row = (size_t)ndir * H;  // lanes of a batch row of dy, dhhn
  const size_t ps = (size_t)B * Hp;     // stride of the planes
  S* dgx_t = dgx + (size_t)t * B * ndir * h3 + d * h3;
  const size_t plane_t = (size_t)t * B * row + (size_t)d * H;
  const float* pl_t =
      planes + ((size_t)d * T + t) * GruCell::kPlanes * ps + unit;

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
            const float* wrow = w + (size_t)unit_c * h3;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              wk[q] = k0 + kk + q < H3 ? wrow[k0 + kk + q] : 0.f;
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

    // ---- phase C: the gate backward from the planes [P_r|P_z|P_n|P_hn|Z]
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      if (!unit_ok || b >= B) continue;
      const float* pl = pl_t + (size_t)b * Hp;
      const size_t o_t = plane_t + (size_t)b * row + unit;
      float* dhp = dh + (size_t)b * H + unit;
      const float dh_t = load_f(dy + o_t) + *dhp;
      const float dpre_r = dh_t * pl[0];
      const float dpre_z = dh_t * pl[ps];
      const float dpre_n = dh_t * pl[2 * ps];
      const float dhh_n = dh_t * pl[3 * ps];
      *dhp = dh_t * pl[4 * ps];
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
    gru_bidir_bwd_kernel(const float* __restrict__ planes,
                         const float* __restrict__ w_hh,
                         const S* __restrict__ dy, S* __restrict__ dgx,
                         S* __restrict__ dhhn, float* dpbuf, float* dhbuf,
                         int T, int B, int H, int Hp, int ldh, int ndir) {
  extern __shared__ float4 smem[];
  // kResident: wr_s [K4/4][kUnits], four consecutive gate columns of the
  // unit's row per entry
  const int H3 = 3 * H;
  const int K4 = (H3 + 3) / 4 * 4;
  float4* wr_s = smem;
  float* tiles = reinterpret_cast<float*>(
      smem + (kResident ? (size_t)(K4 / 4) * kUnits : 0));  // [2][tile]

  const int groups = (H + kUnits - 1) / kUnits;
  const int items = ndir * groups;
  const size_t h3 = 3 * (size_t)H;

  if constexpr (kResident) {
    const int d = blockIdx.x / groups;
    const int u0 = (blockIdx.x % groups) * kUnits;
    const float* w = w_hh + (size_t)d * H * h3;
    for (int idx = threadIdx.x; idx < (K4 / 4) * kUnits; idx += 32 * kUnits) {
      const int k = 4 * (idx / kUnits), un = u0 + idx % kUnits;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (un < H) {
        const float* wrow = w + (size_t)un * h3;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < H3) v[q] = wrow[k + q];
      }
      wr_s[idx] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < T; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int d = item / groups;
      const int u0 = (item % groups) * kUnits;
      float* dp = dpbuf + (size_t)d * 2 * K4 * ldh;  // [2][K4][ldh], zeroed
      gru_bwd_item<S, kResident>(
          planes, w_hh + (size_t)d * H * h3, wr_s, dy, dgx, dhhn,
          dp + (size_t)((s + 1) & 1) * K4 * ldh,
          dp + (size_t)(s & 1) * K4 * ldh, dhbuf + (size_t)d * B * H, tiles,
          d == 0 ? T - 1 - s : s, s == 0, u0, d, T, B, H, Hp, K4, ldh, ndir);
    }
    grid.sync();
  }
}

size_t gru_bwd_smem_bytes(int H, bool resident) {
  const size_t k4 = (3 * (size_t)H + 3) / 4 * 4;
  return (resident ? (k4 / 4) * kUnits * sizeof(float4) : 0) +
         2 * (size_t)kTileFloats * sizeof(float);
}

// The serial chain on the branch that cluster_branch chose (BwdBranch).
template <typename S>
cudaError_t gru_launch_bwd(const void* planes, const void* w_hh,
                           const void* dy, void* dgx, void* dhhn, void* dpbuf,
                           void* dhbuf, int T, int B, int H, int Hp, int ldh,
                           int ndir, int branch, cudaStream_t stream) {
  if (branch == kBwdMma16)
    return launch_cluster<GruCell, 1>(planes, w_hh, dy, dgx, dhhn, T, B, H, Hp,
                                      ndir, stream);
  if (branch == kBwdMma32)
    return launch_cluster<GruCell, 2>(planes, w_hh, dy, dgx, dhhn, T, B, H, Hp,
                                      ndir, stream);
  if (branch == kBwdFma16)
    return launch_bwd_fma<GruCell>(planes, w_hh, dy, dgx, dhhn, T, B, H, Hp,
                                   ndir, stream);
  if (branch == kBwdWide)  // its exchange buffer and step flags
    return launch_bwd_wide<GruCell>(planes, w_hh, dy, dgx, dhhn, dpbuf, dhbuf,
                                    T, B, H, Hp, ndir, stream);
  void* args[] = {&planes, &w_hh, &dy, &dgx, &dhhn, &dpbuf, &dhbuf,
                  &T,      &B,    &H,  &Hp,  &ldh,  &ndir};
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

// Backward pre-pass.  gx (T, B, ndir * 3H) and ys (T, B, ndir * H) in the
// stream type; w: with bf16 streams w_hh^T (ndir, 3H, H) bf16, else w_hh
// (ndir, H, 3H) fp32, rounded to the stream type by the caller; planes
// (ndir, T, 5, B, Hp) fp32 with Hp >= H a multiple of 4.
// Returns a cudaError_t; 0 means launched.
int gru_bidir_train_bwd_prepass(const void* gx, const void* w_hh,
                                const void* ys, void* planes, int T, int B,
                                int H, int Hp, int ndir, int bf16,
                                void* stream) {
  if (Hp < H || Hp % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch_prepass<GruCell>(gx, w_hh, ys, nullptr, planes, T, B, H,
                                      Hp, ndir, bf16,
                                      static_cast<cudaStream_t>(stream));
}

// The serial chain's branch for a backward of this shape on the current
// device: *branch 0 the grid, 1 or 2 the bf16 cluster of 16 or 32 rows, 3
// the fp32 cluster, 4 the wide branch (BwdBranch).  Returns a cudaError_t.
int gru_bidir_train_bwd_branch(int B, int H, int ndir, int bf16, int* branch) {
  return (int)cluster_branch<GruCell>(B, H, ndir, bf16, branch);
}

// The wide branch's scratch at this shape on the current device: *floats
// of exchange buffer and *ints of step flags (0 where it has no shape).
// Returns a cudaError_t.
int gru_bidir_train_bwd_wide_scratch(int B, int H, int ndir, size_t* floats,
                                     size_t* ints) {
  return (int)bwd_wide_scratch<GruCell>(B, H, ndir, floats, ints);
}

// Backward serial chain over the pre-pass planes.  dy, dhhn (T, B, ndir *
// H) and dgx (T, B, ndir * 3H) in the stream type; w_hh as above; the
// scratch, by branch (null for the clusters): the grid's dpbuf (ndir, 2,
// K4, ldh) with K4 = 3H rounded up to a multiple of 4 and ldh >= B a
// multiple of 4, and dhbuf (ndir, B, H), both fp32 zeros; the wide
// branch's exchange buffer (fp32) as dpbuf and its step flags (int32) as
// dhbuf, sized by gru_bidir_train_bwd_wide_scratch (the library zeroes the
// flags on the stream).  *branch: the branch launched, as
// gru_bidir_train_bwd_branch numbers them.  Returns a cudaError_t; 0 means
// launched.
int gru_bidir_train_backward(const void* planes, const void* w_hh,
                             const void* dy, void* dgx, void* dhhn,
                             void* dpbuf, void* dhbuf, int T, int B, int H,
                             int Hp, int ldh, int ndir, int bf16,
                             void* stream, int* branch) {
  *branch = -1;
  if (ldh < B || ldh % 4 != 0 || Hp < H || Hp % 4 != 0 || ndir < 1 ||
      ndir > 2)
    return (int)cudaErrorInvalidValue;
  int plan = 0;
  cudaError_t err = cluster_branch<GruCell>(B, H, ndir, bf16, &plan);
  if (err != cudaSuccess) return (int)err;
  if ((plan == kBwdGrid || plan == kBwdWide) && (!dpbuf || !dhbuf))
    return (int)cudaErrorInvalidValue;
  if (plan == kBwdWide && bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? gru_launch_bwd<__nv_bfloat16>(planes, w_hh, dy, dgx, dhhn,
                                             dpbuf, dhbuf, T, B, H, Hp, ldh,
                                             ndir, plan, st)
             : gru_launch_bwd<float>(planes, w_hh, dy, dgx, dhhn, dpbuf, dhbuf,
                                     T, B, H, Hp, ldh, ndir, plan, st);
  if (err == cudaSuccess) *branch = plan;
  return (int)err;
}

const char* gru_bidir_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
