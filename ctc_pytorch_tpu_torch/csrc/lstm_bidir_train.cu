// Trainable bidirectional LSTM recurrence for Hopper (sm_90a): a forward
// kernel that keeps what the backward needs, and the backward's gate
// pre-pass and serial chain.
//
// Replaces ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py: the forward
// pallas_call (_fwd_pallas, kernel _make_fwd_kernel) and the backward
// pallas_call (_bwd_pallas, kernel _make_bwd_kernel, the hoisted form:
// _lstm_prepass and its step).
//
// Forward: gx (T, B, 8H) in the stream type S, w_hh (2, H, 4H) fp32
// (already rounded to S by the caller) -> ys (T, B, 2H) and the cell states
// cs (T, B, 2H), both in S.  The carries are fp32; with bf16 streams h
// enters the next step's product as ys holds it.  Three kinds of branch,
// chosen by the launcher and reported: the cluster branch of
// fwd_cluster.cuh (bf16 streams: the tensor-core kernel, 16 or 32 batch rows
// a cluster; fp32 streams: the fp32 kernel, 16 rows a cluster of up to 16
// CTAs), the wide branch of fwd_wide.cuh where no cluster holds the shape
// (one persistent CTA an SM, weights resident, h exchanged through L2
// under step flags: wide_fp32 on fp32 streams, 3xTF32 products; wide_bf16
// on bf16 streams, bf16 mma.sync m16n8k16, DeepSpeech2's H = 1024 at B =
// 64), and the grid kernel of lstm_fwd.cuh with kTrain = true past the wide
// branch's bound (the eval kernel's design, lstm_bidir.cu, plus one more
// plane).
//
// Backward: the hoisted form of the JAX kernel (_lstm_prepass and its
// step), in two launches; bwd_hoist.cuh holds the design notes and the two
// kernels shared with the GRU.
// (a) The pre-pass (lstm_bidir_train_bwd_prepass): gates = gx[t] + h_prev(t)
//     @ w_hh for every (t, b, direction) at once, h_prev(t) the saved row of
//     ys (t-1 for direction 0, t+1 for direction 1, zero outside), folded
//     with cs into six fp32 planes [A | Gi | Gf | Gg | Go | F] (ndir, T, 6,
//     B, Hp).  No carry enters it, so it is off the serial chain.
// (b) The serial chain (lstm_bidir_train_backward): direction 0 from
//     t = T-1 down, direction 1 from t = 0 up; per step, with dh_t = dy[t] +
//     dh:  dct = dc + dh_t A,  dpre = [dct Gi, dct Gf, dct Gg, dh_t Go] -> dgx
//     in S,  dc = dct F,  dh = dpre(as S) @ w_hh^T.  The product contracts
//     over all 4H gate columns, so the CTAs of a batch row exchange it.
//
// What bounds it: the T steps of (b) are a serial chain; the card's limits
// are far below that.  The work is two (B, H) x (H, 4H)-sized products per
// step and direction, 48.3 GFLOP at T=80, B=128, H=384, and gx, ys, cs, dy
// in, dgx out.  With bf16 streams every product operand is a bf16 value
// (tensor cores, 989 TFLOP/s: ~0.05 ms), so the limit is the bytes: ~0.18
// GB, ~0.053 ms at 3.35 TB/s; the pre-pass planes add 189 MB written and
// read once.  With fp32 streams the products are fp32 and the limit is
// operations at 67 TFLOP/s.
//
// Four branches for (b), chosen by the launcher, which reports the one it
// took (bwd_hoist.cuh, BwdBranch): two cluster branches, each a cluster per
// (direction, batch rows) with w_hh resident across it and the partial dh
// exchanged in distributed shared memory -- bwd_cluster_kernel for bf16
// streams (H <= 416: tensor cores, 16 or 32 batch rows), bwd_fma_kernel for
// fp32 streams (H <= 432: fp32 FMA, 16 rows, clusters of 8 or 16 CTAs) --
// the wide branch for fp32 streams where those clusters do not all fit (B
// >= 64 at H = 384; bwd_wide.cuh: one persistent CTA an SM, 3xTF32 on the
// tensor cores, the partial dh exchanged through L2 under step flags), and
// for every other shape (H past the bounds) the grid branch below: one persistent cooperative grid, CTA (d, g) owning
// 8 hidden units of direction d, each thread one unit and 4 batch rows, the
// unit's 8 rows of w_hh resident in shared memory (128*H + 64 KB,
// co-resident while 2*ceil(H/8) <= SMs, H <= 528 on a 132-SM H100; past
// that the grid strides over the items and reads w_hh from L2).  Per step:
//   phase B  dh for the owned units from the previous step's dpre, which
//            all CTAs wrote transposed, (4H, ldh), into a global double
//            buffer (L2), streamed through shared memory with cp.async;
//   phase C  the cell backward from the planes, dgx and the exchange write;
//   grid.sync().
// dh and dc live in global scratch that only the owning thread touches.
// dW_hh is formed outside from shifted ys against dgx (two plain GEMMs), as
// the JAX package does.

#include "bwd_hoist.cuh"
#include "fwd_cluster.cuh"

namespace {

// One backward step of work item (d, u0) at forward time t (grid branch).
template <typename S, bool kResident>
__device__ __forceinline__ void bwd_item(
    const float* __restrict__ planes, const float* __restrict__ w,
    const float4* wr_s, const S* __restrict__ dy, S* __restrict__ dgx,
    const float* dp_prev, float* dp_next, float* dh, float* dc, float* tiles,
    int t, bool first, int u0, int d, int T, int B, int H, int Hp, int ldh,
    int ndir) {
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rq = tid / kUnits;  // row group, 0..31
  const int unit = u0 + u;
  const bool unit_ok = unit < H;
  const int unit_c = min(unit, H - 1);
  const int H4 = 4 * H;
  const size_t h4 = 4 * (size_t)H;
  const size_t row = (size_t)ndir * H;  // lanes of a batch row of dy
  const size_t ps = (size_t)B * Hp;     // stride of the planes
  S* dgx_t = dgx + (size_t)t * B * ndir * h4 + d * h4;
  const float* pl_t =
      planes + ((size_t)d * T + t) * LstmCell::kPlanes * ps + unit;

  for (int r0 = 0; r0 < B; r0 += kRowTile) {
    const bool rows_live = r0 + rq * kRows < B;

    // ---- phase B: dh[b, unit] = sum_col dpre_prev[col, b] * w[unit, col]
    if (!first) {
      const int n_tiles = (H4 + kTileK - 1) / kTileK;
      float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
      stage(tiles, dp_prev, 0, r0, H4, ldh, tid);
      GRID_STAMP(0)  // the first tile issued
      for (int kt = 0; kt < n_tiles; ++kt) {
        if (kt + 1 < n_tiles) {
          stage(tiles + ((kt + 1) & 1) * kTileFloats, dp_prev,
                (kt + 1) * kTileK, r0, H4, ldh, tid);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        GRID_STAMP(1)  // the staging: copies issued, waited for, the barrier
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
        GRID_STAMP(2)  // the product of the tile and the barrier after it
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int b = r0 + rq * kRows + j;
        if (unit_ok && b < B) dh[(size_t)b * H + unit] = acc[j];
      }
    }

    // ---- phase C: the cell backward from the planes [A|Gi|Gf|Gg|Go|F]
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      if (!unit_ok || b >= B) continue;
      const float* pl = pl_t + (size_t)b * Hp;
      float* dhp = dh + (size_t)b * H + unit;
      float* dcp = dc + (size_t)b * H + unit;
      const float dh_t =
          load_f(dy + (size_t)t * B * row + (size_t)b * row + d * H + unit) +
          *dhp;
      const float dct = *dcp + dh_t * pl[0];
      const float dpre[4] = {dct * pl[ps], dct * pl[2 * ps], dct * pl[3 * ps],
                             dh_t * pl[4 * ps]};
      *dcp = dct * pl[5 * ps];
      S* out = dgx_t + (size_t)b * ndir * h4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        store_f(out + q * H, dpre[q]);
        dp_next[(size_t)(q * H + unit) * ldh + b] = round_to(dpre[q], out);
      }
    }
    GRID_STAMP(3)  // the cell backward, dgx and the exchange write
  }
}

template <typename S, bool kResident>
__global__ void __launch_bounds__(32 * kUnits)
    lstm_bidir_bwd_kernel(const float* __restrict__ planes,
                          const float* __restrict__ w_hh,
                          const S* __restrict__ dy, S* __restrict__ dgx,
                          float* dpbuf, float* dhbuf, float* dcbuf, int T,
                          int B, int H, int Hp, int ldh, int ndir) {
  extern __shared__ float4 smem[];
  // kResident: wr_s [H][kUnits], four consecutive gate columns of the
  // unit's row per entry
  float4* wr_s = smem;
  float* tiles = reinterpret_cast<float*>(
      smem + (kResident ? (size_t)H * kUnits : 0));  // [2][kTileFloats]

  const int groups = (H + kUnits - 1) / kUnits;
  const int items = ndir * groups;
  const size_t h4 = 4 * (size_t)H;

  if constexpr (kResident) {
    const int d = blockIdx.x / groups;
    const int u0 = (blockIdx.x % groups) * kUnits;
    const float* w = w_hh + (size_t)d * H * h4;
    for (int idx = threadIdx.x; idx < H * kUnits; idx += 32 * kUnits) {
      const int k = idx / kUnits, un = u0 + idx % kUnits;
      float4 vr = make_float4(0.f, 0.f, 0.f, 0.f);
      if (un < H)
        vr = *reinterpret_cast<const float4*>(w + (size_t)un * h4 + 4 * k);
      wr_s[idx] = vr;
    }
  }

  cg::grid_group grid = cg::this_grid();
  GRID_STAMP_START
  for (int s = 0; s < T; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int d = item / groups;
      const int u0 = (item % groups) * kUnits;
      float* dp = dpbuf + (size_t)d * 2 * h4 * ldh;  // [2][4H][ldh]
      bwd_item<S, kResident>(
          planes, w_hh + (size_t)d * H * h4, wr_s, dy, dgx,
          dp + (size_t)((s + 1) & 1) * h4 * ldh, dp + (size_t)(s & 1) * h4 * ldh,
          dhbuf + (size_t)d * B * H, dcbuf + (size_t)d * B * H, tiles,
          d == 0 ? T - 1 - s : s, s == 0, u0, d, T, B, H, Hp, ldh, ndir);
    }
    grid.sync();
    GRID_STAMP(4)  // grid.sync()
  }
}

size_t bwd_smem_bytes(int H, bool resident) {
  return (resident ? (size_t)H * kUnits * sizeof(float4) : 0) +
         2 * (size_t)kTileFloats * sizeof(float);
}

// The serial chain on the branch that cluster_branch chose (BwdBranch).
template <typename S>
cudaError_t launch_bwd(const void* planes, const void* w_hh, const void* dy,
                       void* dgx, void* dpbuf, void* dhbuf, void* dcbuf, int T,
                       int B, int H, int Hp, int ldh, int ndir, int branch,
                       cudaStream_t stream) {
  if (branch == kBwdMma16)
    return launch_cluster<LstmCell, 1>(planes, w_hh, dy, dgx, nullptr, T, B, H,
                                       Hp, ndir, stream);
  if (branch == kBwdMma32)
    return launch_cluster<LstmCell, 2>(planes, w_hh, dy, dgx, nullptr, T, B, H,
                                       Hp, ndir, stream);
  if (branch == kBwdFma16)
    return launch_bwd_fma<LstmCell>(planes, w_hh, dy, dgx, nullptr, T, B, H,
                                    Hp, ndir, stream);
  if (branch == kBwdWide)  // its exchange buffer and step flags
    return launch_bwd_wide<LstmCell>(planes, w_hh, dy, dgx, nullptr, dpbuf,
                                     dhbuf, T, B, H, Hp, ndir, stream);
  void* args[] = {&planes, &w_hh, &dy, &dgx, &dpbuf, &dhbuf, &dcbuf,
                  &T,      &B,    &H,  &Hp,  &ldh,   &ndir};
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

// The forward's branch for this shape on the current device: *branch 0
// the grid, 1 or 2 the bf16 cluster of 16 or 32 rows, 3 the fp32 cluster,
// 4 the wide branch on fp32 streams, 5 on bf16 streams (FwdBranch).
// Returns a cudaError_t.
int lstm_bidir_train_fwd_branch(int B, int H, int ndir, int bf16,
                                int* branch) {
  return (int)(bf16
                   ? fwd_branch<LstmCell, __nv_bfloat16, true>(B, H, ndir, branch)
                   : fwd_branch<LstmCell, float, true>(B, H, ndir, branch));
}

// Forward.  gx (T, B, ndir * 4H), ys and cs (T, B, ndir * H) in the stream
// type (bf16 != 0: bfloat16, else float32); w_hh (ndir, H, 4H) fp32; ndir 1
// or 2.  The scratch, by branch (null for the clusters): the grid's hbuf
// (ndir, 2, H, ldh) with ldh >= B a multiple of 4, and cbuf (ndir, B, H),
// both fp32 zeros; the wide branch's exchange buffer as hbuf and its step
// flags as cbuf (lstm_bidir.cu says their sizes; on bf16 streams the buffer
// is bf16, wide_hx_bf16 elements).  *branch: the branch
// launched, as lstm_bidir_train_fwd_branch numbers them.  Returns a
// cudaError_t; 0 means launched.
int lstm_bidir_train_forward(const void* gx, const void* w_hh, void* ys,
                             void* cs, void* hbuf, void* cbuf, int T, int B,
                             int H, int ldh, int ndir, int bf16,
                             void* stream, int* branch) {
  *branch = -1;
  if (ldh < B || ldh % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  int plan = 0;
  cudaError_t err = (cudaError_t)lstm_bidir_train_fwd_branch(B, H, ndir, bf16,
                                                             &plan);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan == kFwdGrid) {
    if (!hbuf || !cbuf) return (int)cudaErrorInvalidValue;
    err = bf16 ? launch<__nv_bfloat16, true>(gx, w_hh, ys, cs, hbuf, cbuf, T,
                                              B, H, ldh, ndir, st)
               : launch<float, true>(gx, w_hh, ys, cs, hbuf, cbuf, T, B, H,
                                     ldh, ndir, st);
  } else if (plan == kFwdWide || plan == kFwdWideBf16) {
    // wide_fp32 on fp32 streams, wide_bf16 on bf16 streams
    err = bf16 ? launch_fwd_wide<LstmCell, __nv_bfloat16, true>(
                     gx, w_hh, ys, cs, hbuf, cbuf, T, B, H, ndir, st)
               : launch_fwd_wide<LstmCell, float, true>(
                     gx, w_hh, ys, cs, hbuf, cbuf, T, B, H, ndir, st);
  } else {
    err = bf16 ? launch_fwd_cluster<LstmCell, __nv_bfloat16, true>(
                     plan, gx, w_hh, ys, cs, T, B, H, ndir, st)
               : launch_fwd_cluster<LstmCell, float, true>(
                     plan, gx, w_hh, ys, cs, T, B, H, ndir, st);
  }
  if (err == cudaSuccess) *branch = plan;
  return (int)err;
}

// Backward pre-pass.  gx (T, B, ndir * 4H), ys and cs (T, B, ndir * H) in
// the stream type; w: with bf16 streams w_hh^T (ndir, 4H, H) bf16, else
// w_hh as above; planes (ndir, T, 6, B, Hp) fp32 with Hp >= H a multiple of
// 4.  Returns a cudaError_t; 0 means launched.
int lstm_bidir_train_bwd_prepass(const void* gx, const void* w_hh,
                                 const void* ys, const void* cs, void* planes,
                                 int T, int B, int H, int Hp, int ndir,
                                 int bf16, void* stream) {
  if (Hp < H || Hp % 4 != 0 || ndir < 1 || ndir > 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch_prepass<LstmCell>(gx, w_hh, ys, cs, planes, T, B, H, Hp,
                                       ndir, bf16,
                                       static_cast<cudaStream_t>(stream));
}

// The serial chain's branch for a backward of this shape on the current
// device: *branch 0 the grid, 1 or 2 the bf16 cluster of 16 or 32 rows, 3
// the fp32 cluster, 4 the wide branch (BwdBranch).  Returns a cudaError_t.
int lstm_bidir_train_bwd_branch(int B, int H, int ndir, int bf16,
                                int* branch) {
  return (int)cluster_branch<LstmCell>(B, H, ndir, bf16, branch);
}

// The wide branch's scratch at this shape on the current device: *floats
// of exchange buffer and *ints of step flags (0 where it has no shape).
// Returns a cudaError_t.
int lstm_bidir_train_bwd_wide_scratch(int B, int H, int ndir, size_t* floats,
                                      size_t* ints) {
  return (int)bwd_wide_scratch<LstmCell>(B, H, ndir, floats, ints);
}

// Backward serial chain over the pre-pass planes.  dy (T, B, ndir * H) and
// dgx (T, B, ndir * 4H) in the stream type; w_hh as above; the scratch, by
// branch (null for the clusters): the grid's dpbuf (ndir, 2, 4H, ldh),
// dhbuf and dcbuf (ndir, B, H), fp32 zeros; the wide branch's exchange
// buffer (fp32) as dpbuf and its step flags (int32) as dhbuf, sized by
// lstm_bidir_train_bwd_wide_scratch (the library zeroes the flags on the
// stream).  *branch: the branch launched, as lstm_bidir_train_bwd_branch
// numbers them.  Returns a cudaError_t; 0 means launched.
int lstm_bidir_train_backward(const void* planes, const void* w_hh,
                              const void* dy, void* dgx, void* dpbuf,
                              void* dhbuf, void* dcbuf, int T, int B, int H,
                              int Hp, int ldh, int ndir, int bf16,
                              void* stream, int* branch) {
  *branch = -1;
  if (ldh < B || ldh % 4 != 0 || Hp < H || Hp % 4 != 0 || ndir < 1 ||
      ndir > 2)
    return (int)cudaErrorInvalidValue;
  int plan = 0;
  cudaError_t err = cluster_branch<LstmCell>(B, H, ndir, bf16, &plan);
  if (err != cudaSuccess) return (int)err;
  if ((plan == kBwdGrid && (!dpbuf || !dhbuf || !dcbuf)) ||
      (plan == kBwdWide && (bf16 || !dpbuf || !dhbuf)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_bwd<__nv_bfloat16>(planes, w_hh, dy, dgx, dpbuf, dhbuf,
                                         dcbuf, T, B, H, Hp, ldh, ndir, plan,
                                         st)
             : launch_bwd<float>(planes, w_hh, dy, dgx, dpbuf, dhbuf, dcbuf, T,
                                 B, H, Hp, ldh, ndir, plan, st);
  if (err == cudaSuccess) *branch = plan;
  return (int)err;
}

const char* lstm_bidir_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
