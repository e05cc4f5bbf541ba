// The cluster branches of the LSTM, GRU and tanh forward recurrences and of
// the tanh backward for Hopper (sm_90a), shared by lstm_bidir.cu (eval),
// lstm_bidir_train.cu (training forward), gru_bidir.cu (eval and training
// forward), rnn_bidir.cu (the tanh forward, eval and training) and
// rnn_bidir_train.cu (the tanh backward).
//
// Replaces, with the grid kernels of lstm_fwd.cuh, gru_fwd.cuh, rnn_fwd.cuh
// and rnn_bidir_train.cu as the branch for the shapes that no cluster holds:
//   ctc_pytorch_tpu/ops/lstm_pallas_v2.py:142 lstm_bidir_pallas_v2 (the
//     pallas_call at :177, cell _cell2);
//   ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py:438, the forward
//     pallas_call of lstm_scan_train_v2;
//   ctc_pytorch_tpu/ops/gru_pallas_v2.py:352, the forward pallas_call
//     shared by gru_bidir_v2 and gru_scan_train_v2;
//   ctc_pytorch_tpu/ops/rnn_pallas_v2.py:228 (_fwd_pallas, shared by
//     rnn_bidir_v2 and rnn_scan_v2) and :258 (_bwd_pallas, the backward of
//     rnn_scan_v2, VJP :296-315).
// The function is the grid kernels' (lstm_bidir.cu, lstm_bidir_train.cu,
// gru_bidir.cu, rnn_bidir.cu, rnn_bidir_train.cu say it), rounding where
// they round: the LSTM eval forward multiplies fp32 h by fp32 w_hh at every
// stream dtype; the LSTM training forward, the GRU and the tanh cell round
// w_hh (the caller does) and the h (the tanh backward: dpre) that enters
// the product to the stream type S.  Gate math and the carries (c, the
// GRU's h) are fp32.
//
// The tanh cell (TanhCell: h = tanh(gx + hh), no carry) runs on the same
// kernels, and so does its backward (TanhBwdCell), which has the forward's
// shape exactly: dpre = (dy + round_S(dpre') @ w_hh^T) (1 - y^2) is a value
// exchanged every step that feeds a (B, H) x (H, H) product.  Its policy:
// the resident weights are rows of w_hh, the step reads two planes (dy in
// the place of gx, and the saved ys), stores dgx in S where the forward
// stores ys, and direction 0 walks time from T - 1 down (step_time).
//
// What bounds it: the T steps are a serial chain, and a step is a (B, H) x
// (H, G H) product per direction, 19 MFLOP at B = 8, H = 384: latency, not
// work.  The grid kernels pay a grid-wide barrier, an L2 round trip of h and
// 12 tile barriers a step (17-23 us).  Here nothing goes through L2 within a
// step:
//
// One thread-block cluster per (direction, slice of 16 or 32 batch rows).
// CTA r of a cluster of CL owns Uc hidden units [r Uc, r Uc + Uc) and keeps
// the w_hh columns of all G gates of those units resident in shared memory
// for the whole launch.  It holds the whole h_{t-1} of its rows (double
// buffered), computes the gates of its own units, and writes its slice of
// h_t into every peer's buffer with st.shared::cluster; one cluster barrier
// a step (release arrive after the writes, acquire wait before the next
// product) replaces grid.sync().  Splitting the units (not the contraction,
// as the backward does) moves the fewest bytes: h itself, H wide; at H =
// 384, 16 rows, bf16, a cluster of 8 sends 1.5 KB to each peer a step.  The
// carries stay in the registers of the thread that owns the (row, unit);
// the next step's gx is loaded while the step's barrier completes; ys (and
// the training forward's cs) are stored after the release arrive.
//
// Three cluster kernels, by the type of the product's operands and the
// gate count:
//   fwd_mma_kernel (branches cluster16, cluster32), bf16 operands: the LSTM
//     training forward and the GRU on bf16 streams.  mma.sync m16n8k16 on
//     ldmatrix fragments, fp32 sums; warp w owns unit block w (8 units) and
//     all G gate n-tiles of it, so the gate math of a (row, unit) finds all
//     its sums in one thread.  16 or 32 rows a cluster (one or two m16
//     tiles sharing each weight fragment); 32 where the 16-row clusters
//     would not all be resident at once (the card holds 15 clusters of 8
//     one-CTA-per-SM blocks).  Resident: G Uc x H bf16, Uc = ceil(H / 8)
//     rounded up to 8, CL <= 8: 147 KB at LSTM H = 384, 49 KB at GRU H = 256,
//     37.6 KB at tanh H = 384 (Uc = 48, CL = 8; 63 KB a CTA with the h
//     buffers of 16 rows, 88 KB with 32).  Bound: the weights and the h
//     buffers within 227 KB: LSTM H <= 432 (32 rows: H <= 384), GRU H <= 496
//     (32 rows: H <= 448); tanh H <= 512 with 16 and with 32 rows, where
//     the 8 warps of 8 units (Uc <= 64) and not the shared memory end it.
//   fwd_fma_kernel (branch cluster16_fp32), fp32 operands: the LSTM eval
//     forward at every stream dtype and every forward on fp32 streams (the
//     flagship recipe's batch of 8).  fp32 FMA on CUDA cores (no TF32).  At
//     H = 384 fp32 w_hh is 2.36 MB a direction: 295 KB a CTA in a cluster
//     of 8, so the kernel takes a 16-CTA cluster (non-portable, 147 KB a
//     CTA) where 8 does not fit; a split of the weights between shared
//     memory and registers would keep 8 but leave 148 registers of weights
//     a thread beside the sums.  Thread (unit, 4-row group, k slice): the
//     units are a warp's fastest index (a shared-memory wavefront reads
//     eight adjacent units of one k row), the k slices of a (unit, rows)
//     pair are summed by shuffles, and each slice then does the gate math
//     of one row and the stores to some of the peers.
//     16 rows a cluster.  Bound: H <= 309 at CL = 8, H <= 416 at CL = 16.
//   fma1_kernel (branch cluster16_fp32), fp32 operands of the one-gate
//     cell (the tanh forward and backward on fp32 streams, the recipe's
//     batch of 8).  fwd_fma_kernel's float4 per (k, unit) would hold one
//     gate and three zeros: three quarters of the resident memory and of
//     the product wasted, and H = 384 pushed to a cluster of 16.  Here a
//     float4 holds four adjacent units (Uc a multiple of 4), as the grid
//     kernel's w_s[k * kUnits + u]: fp32 w_hh at H = 384 is 74 KB a CTA in
//     a portable cluster of 8 (120 KB with the h buffers), and a thread
//     (4 units, 4-row group, k slice) does 16 FMAs a k as the gated
//     kernel does; the k slices then reduce-scatter their 16 sums.  16
//     rows a cluster.  Bound: resident w_hh (4 H Uc bytes) and the h
//     buffers (128 H) within 227 KB: H <= 558 at CL = 8, H <= 726 at
//     CL = 16.  At H = 384 a CTA takes 120 KB, one an SM, and the card
//     holds 15 clusters of 8: B <= 112 with two directions.
// What a step costs: tools/probe_bwd_steps.py stamps each phase (PERF.md
// §7 has the cycles).  The fp32 kernel's step is about 60% product; the
// bf16 kernel's is a third product and a third gate math at 32 rows, a
// quarter each at 16; the DSMEM stores and the cluster barrier take 1-3k
// cycles in both.
// The launcher asks cudaOccupancyMaxActiveClusters once per (device, B, H,
// ndir, kernel) and takes a cluster branch only where the weights fit and
// every cluster of the launch can be resident at once.  Where fp32 products
// find no cluster (B >= 64 at H = 384 for the gated cells: 8 or 16
// clusters of 16 CTAs; B >= 113 for the tanh cell and its backward: 16 or
// more clusters of 8; H past the cluster bound) it takes the wide branch of
// fwd_wide.cuh (kFwdWide: a persistent cooperative kernel, weights
// resident across every SM, the product on the tensor cores in 3xTF32, h
// (the tanh backward: dpre) exchanged through L2 under per-block step
// flags) where its resident weights fit; otherwise the grid kernel.  Where
// bf16 products find no cluster (LSTM H > 432, GRU H > 496, or more
// clusters than the card holds: DeepSpeech2's H = 1024 at B = 64), the
// gated cells take the wide kernel's bf16 form (kFwdWideBf16: weights
// resident as bf16, mma.sync m16n8k16, h exchanged as bf16) where its
// weights fit, and the grid past that; the tanh cell and its backward keep
// the grid there.  The entry points report the branch they launched.

#pragma once

#include <type_traits>

#include "bwd_hoist.cuh"
#include "gru_fwd.cuh"

namespace {

constexpr int kFmaThreads = 256;
constexpr int kFmaRows = 16;  // batch rows of an fp32 cluster

// Phase stamps of a forward step, for tools/probe_bwd_steps.py: built with
// FWD_STEP_STAMPS defined, thread 0 of the first CTA adds the clock64()
// cycles since the stamp before to fwd_step_cycles[i] at stamp i.  The
// package's build leaves them out.
#ifdef FWD_STEP_STAMPS
__device__ long long fwd_step_cycles[8];
#define FWD_STAMP_START                                                   \
  const bool fstamp_ = threadIdx.x == 0 && blockIdx.x == 0 &&            \
                       blockIdx.y == 0 && blockIdx.z == 0;                \
  long long flast_ = clock64();
#define FWD_STAMP(i)                                                      \
  if (fstamp_) {                                                          \
    const long long now_ = clock64();                                     \
    fwd_step_cycles[i] += now_ - flast_;                                  \
    flast_ = now_;                                                        \
  }
#else
#define FWD_STAMP_START
#define FWD_STAMP(i)
#endif

// forward branches, as the entry points report them
enum FwdBranch {
  kFwdGrid = 0,
  kFwdMma16 = 1,
  kFwdMma32 = 2,
  kFwdFma16 = 3,
  kFwdWide = 4,      // wide_fp32
  kFwdWideBf16 = 5   // wide_bf16
};

// 32 bits into the shared memory of CTA `rank` of the cluster, at the
// address that p has in this CTA's.
__device__ __forceinline__ void st_cluster_b32(void* p, int rank, unsigned v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

// two floats as packed bf16, the second zero unless n > 1
__device__ __forceinline__ unsigned pack2_bf16(float a, float b, int n) {
  return bf16_bits(a) | (n > 1 ? (unsigned)bf16_bits(b) << 16 : 0u);
}

// the first n of 2 packed bf16 at p: one 4-byte store when vec
__device__ __forceinline__ void store2_bf16(__nv_bfloat16* p, unsigned w, int n,
                                            bool vec) {
  if (n <= 0) return;
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
  if (vec && n >= 2) {
    *reinterpret_cast<unsigned*>(q) = w;
    return;
  }
  q[0] = (unsigned short)(w & 0xffff);
  if (n > 1) q[1] = (unsigned short)(w >> 16);
}

// sigmoid_f bit for bit: 1 / y rounded once is the rounded reciprocal,
// which skips the division's slow-path branch
__device__ __forceinline__ float sigmoid_rcp(float x) {
  return __frcp_rn(1.0f + expf(-x));
}

// The one-gate (tanh) cell: h = tanh(gi + hh), with no carry of its own.
struct TanhCell {
  static constexpr int kGates = 1;
};
// The same cell's backward, run on the forward's kernels backward in time:
// the product is dpre_{t+-1} @ w_hh^T (the resident weights are rows of
// w_hh), the step dpre = (dy + dh) (1 - y^2) reads two planes, dy (in the
// place of gx) and the saved ys, and stores dpre (dgx) where the forward
// stores ys; the value exchanged is dpre as the stream type holds it.
struct TanhBwdCell {
  static constexpr int kGates = 1;
};

// whether a cell walks time backward (direction 0 from t = T - 1 down)
template <class Cell>
constexpr bool kBackward = std::is_same<Cell, TanhBwdCell>::value;
// the planes a step reads for each (row, unit): the G gate inputs, and the
// saved ys beside dy for the backward
template <class Cell>
constexpr int kInPlanes = Cell::kGates + (kBackward<Cell> ? 1 : 0);

// forward time of step s of direction d
template <class Cell>
__device__ __forceinline__ int step_time(int s, int d, int T) {
  return (d == 0) != kBackward<Cell> ? s : T - 1 - s;
}

// The gates of one (row, unit) from the sums hh of its G products and its
// inputs gi (kInPlanes): updates the carry (LSTM c, GRU h, fp32) and
// returns h_t (the tanh backward: dpre); *c_out gets the LSTM's c_t.
__device__ __forceinline__ float cell_fwd(LstmCell, const float* hh,
                                          const float* gi, float* carry,
                                          float* c_out) {
  const float ig = sigmoid_rcp(gi[0] + hh[0]);
  const float fg = sigmoid_rcp(gi[1] + hh[1]);
  const float gg = tanhf(gi[2] + hh[2]);
  const float og = sigmoid_rcp(gi[3] + hh[3]);
  const float cn = fg * *carry + ig * gg;
  *carry = cn;
  *c_out = cn;
  return og * tanhf(cn);
}
__device__ __forceinline__ float cell_fwd(GruCell, const float* hh,
                                          const float* gi, float* carry,
                                          float* c_out) {
  const float rg = sigmoid_rcp(gi[0] + hh[0]);
  const float zg = sigmoid_rcp(gi[1] + hh[1]);
  const float ng = tanhf(gi[2] + rg * hh[2]);
  const float hn = (1.0f - zg) * ng + zg * *carry;
  *carry = hn;
  *c_out = 0.f;
  return hn;
}
__device__ __forceinline__ float cell_fwd(TanhCell, const float* hh,
                                          const float* gi, float*,
                                          float* c_out) {
  *c_out = 0.f;
  return tanhf(gi[0] + hh[0]);
}
// gi: dy, then the saved y
__device__ __forceinline__ float cell_fwd(TanhBwdCell, const float* hh,
                                          const float* gi, float*,
                                          float* c_out) {
  *c_out = 0.f;
  return (gi[0] + hh[0]) * (1.0f - gi[1] * gi[1]);
}

// ---------------------------------------------------------------------------
// bf16 products: tensor cores
// ---------------------------------------------------------------------------

// The shape of an mma cluster for H and kM x 16 batch rows: Uc units a CTA
// (a multiple of 8), CL CTAs, the row stride ldk of the bf16 tiles (H
// rounded up to 16, plus 8: conflict-free ldmatrix) and the shared memory:
// the resident weights [G Uc][ldk] and the h double buffer [2][16 kM][ldk].
struct MmaShape {
  int uc, cl, ldk, threads;
  size_t smem;
};

inline MmaShape mma_shape(int gates, int H, int km) {
  MmaShape s;
  s.uc = ((H + 7) / 8 + 7) / 8 * 8;
  s.cl = (H + s.uc - 1) / s.uc;
  s.ldk = (H + 15) / 16 * 16 + 8;
  s.threads = 32 * (s.uc / 8);
  s.smem = ((size_t)gates * s.uc + 2 * 16 * km) * s.ldk * 2;
  return s;
}

// Cluster (direction blockIdx.z, rows [16 kM blockIdx.y, +16 kM)), CTA rank
// blockIdx.x; see the header.  w is w_hh (ndir, H, G H) fp32 holding bf16
// values; gx, ys and cs (LSTM; null for the GRU and the tanh cell) bf16.
// The tanh backward (TanhBwdCell) reads dy as gx and the saved ys as y_in
// (null for every forward cell) and stores dgx as ys.  vec2: gx, y_in, ys
// and cs rows are 4-byte aligned at every even unit (H even).
template <class Cell, int kM>
__global__ void __launch_bounds__(256, 1)
    fwd_mma_kernel(const __nv_bfloat16* __restrict__ gx,
                   const __nv_bfloat16* __restrict__ y_in,
                   const float* __restrict__ w, __nv_bfloat16* __restrict__ ys,
                   __nv_bfloat16* __restrict__ cs, int T, int B, int H,
                   int ndir, int uc, int ldk, int vec2) {
  constexpr int G = Cell::kGates;
  constexpr int NI = kInPlanes<Cell>;
  constexpr int kRowsC = 16 * kM;
  extern __shared__ float4 fwd_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int d = blockIdx.z, r0 = blockIdx.y * kRowsC;
  const int own0 = rank * uc;
  const int nthreads = blockDim.x;
  const int N = G * uc;
  const int nk = (ldk - 8) / 16;  // k-steps of 16
  const size_t gh = (size_t)G * H;
  unsigned short* ws = reinterpret_cast<unsigned short*>(fwd_smem);  // [N][ldk]
  unsigned short* hb = ws + (size_t)N * ldk;  // [2][kRowsC][ldk]

  // resident: column n = q uc + u of this CTA is gate q of unit own0 + u;
  // read along n (coalesced), zero past H in both dimensions, kLoadDepth
  // loads in flight a thread.  The backward's column n is row own0 + n of
  // w_hh (a column of w_hh^T), read along k.
  for (int idx0 = tid; idx0 < N * ldk; idx0 += kLoadDepth * nthreads) {
    float v[kLoadDepth];
#pragma unroll
    for (int i = 0; i < kLoadDepth; ++i) {
      const int idx = idx0 + i * nthreads;
      if constexpr (kBackward<Cell>) {
        const int n = idx / ldk, k = idx % ldk, unit = own0 + n;
        v[i] = idx < N * ldk && k < H && unit < H
                   ? w[((size_t)d * H + unit) * H + k]
                   : 0.f;
      } else {
        const int k = idx / N, n = idx % N;
        const int unit = own0 + n % uc;
        v[i] = idx < N * ldk && k < H && unit < H
                   ? w[((size_t)d * H + k) * gh + (size_t)(n / uc) * H + unit]
                   : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kLoadDepth; ++i) {
      const int idx = idx0 + i * nthreads;
      if (idx >= N * ldk) continue;
      ws[kBackward<Cell> ? idx : (size_t)(idx % N) * ldk + idx / N] =
          bf16_bits(v[i]);
    }
  }
  for (int idx = tid; idx < 2 * kRowsC * ldk; idx += nthreads) hb[idx] = 0;

  // this lane's (row, unit) pairs: m-tile mi, rows g + 8 e, units u0 + j
  const int ul = 8 * warp + 2 * c;  // local unit of j = 0
  const int unit0 = own0 + ul;
  const int nu = min(2, H - unit0);  // units of the pair inside H
  const size_t lanes = (size_t)ndir * H;
  // the carries, and the next step's gate inputs as packed bf16 pairs:
  // loaded without branches or masks (rows past B and units past H read a
  // clamped address; their gate math is never stored nor exchanged) so that
  // all of them are in flight at once, unpacked where they are used
  float carry[kM][2][2];
  unsigned nx[kM][2][NI];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int e = 0; e < 2; ++e) carry[mi][e][0] = carry[mi][e][1] = 0.f;
  auto fetch = [&](int t) {
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = r0 + 16 * mi + g + 8 * e;
        const bool ok = b < B && nu > 0;
        const size_t o = ((size_t)t * B + (ok ? b : 0)) * ndir * gh + d * gh +
                         (ok ? unit0 : 0);
        const __nv_bfloat16* p = gx + o;
#pragma unroll
        for (int q = 0; q < NI; ++q) {
          // plane G (the backward's saved y) has gx's layout, as G = 1
          const __nv_bfloat16* pq = q < G ? p + (size_t)q * H : y_in + o;
          if (vec2) {
            nx[mi][e][q] = *reinterpret_cast<const unsigned*>(pq);
          } else {
            nx[mi][e][q] = load2(pq, ok ? nu : 0, false);
          }
        }
      }
  };
  fetch(step_time<Cell>(0, d, T));
  cluster.sync();  // every CTA of the cluster runs and holds its weights
  FWD_STAMP_START

  for (int s = 0; s < T; ++s) {
    const int t = step_time<Cell>(s, d, T);
    const unsigned short* hcur = hb + (size_t)(s & 1) * kRowsC * ldk;
    unsigned short* hnxt = hb + (size_t)((s + 1) & 1) * kRowsC * ldk;

    // gate sums of the warp's unit block: two chains (even, odd k-steps)
    float acc[kM][2][G][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int q = 0; q < G; ++q)
          acc[mi][h2][q][0] = acc[mi][h2][q][1] = acc[mi][h2][q][2] =
              acc[mi][h2][q][3] = 0.f;
    for (int ks = 0; ks < nk; ks += 2) {
      const bool two = ks + 1 < nk;
      unsigned a[kM][2][4], bq[G][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        ldsm_a(a[mi][0], hcur + 16 * mi * ldk, ldk, 16 * ks, lane);
        if (two) ldsm_a(a[mi][1], hcur + 16 * mi * ldk, ldk, 16 * (ks + 1), lane);
      }
      // one n-tile x k 32 per gate: matrices (k 0-7, 8-15) of k-step ks,
      // then of ks + 1
#pragma unroll
      for (int q = 0; q < G; ++q)
        ldsm_x4(bq[q], ws + (size_t)(q * uc + 8 * warp + (lane & 7)) * ldk +
                           16 * ks + 8 * (lane >> 3));
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          mma_bf16(acc[mi][0][q], a[mi][0], bq[q][0], bq[q][1]);
          if (two) mma_bf16(acc[mi][1][q], a[mi][1], bq[q][2], bq[q][3]);
        }
    }

    FWD_STAMP(0)  // the product
    // gate math; h_t (rounded to bf16) into every peer's next buffer
    unsigned hout[kM][2], cout[kM][2];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float hv[2], cv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float hh[G], gi[NI];
#pragma unroll
          for (int q = 0; q < G; ++q)
            hh[q] = acc[mi][0][q][2 * e + j] + acc[mi][1][q][2 * e + j];
#pragma unroll
          for (int q = 0; q < NI; ++q)
            gi[q] = j ? hi_f(nx[mi][e][q]) : lo_f(nx[mi][e][q]);
          hv[j] = cell_fwd(Cell{}, hh, gi, &carry[mi][e][j], &cv[j]);
        }
        hout[mi][e] = pack2_bf16(hv[0], hv[1], nu);
        cout[mi][e] = pack2_bf16(cv[0], cv[1], nu);
      }
    FWD_STAMP(1)  // the gate math
    if (nu > 0) {
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          unsigned short* dst = hnxt + (16 * mi + g + 8 * e) * ldk + unit0;
          for (int p = 0; p < cl; ++p) st_cluster_b32(dst, p, hout[mi][e]);
        }
    }
    FWD_STAMP(2)  // the DSMEM stores
    cluster_arrive();  // h_t is written
    FWD_STAMP(3)  // the release arrive
    if (s + 1 < T) fetch(step_time<Cell>(s + 1, d, T));
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = r0 + 16 * mi + g + 8 * e;
        const bool ok = b < B && nu > 0;
        const size_t o = ((size_t)t * B + (ok ? b : 0)) * lanes +
                         (size_t)d * H + (ok ? unit0 : 0);
        if (vec2) {  // predicated 4-byte stores, no branches
          if (ok) *reinterpret_cast<unsigned*>(ys + o) = hout[mi][e];
          if (ok && cs != nullptr) *reinterpret_cast<unsigned*>(cs + o) = cout[mi][e];
        } else {
          store2_bf16(ys + o, hout[mi][e], ok ? nu : 0, false);
          if (cs != nullptr) store2_bf16(cs + o, cout[mi][e], ok ? nu : 0, false);
        }
      }
    FWD_STAMP(4)  // the next loads and the global stores issued
    cluster_wait();  // every CTA's h_t is here, and h_{t-1} was read
    FWD_STAMP(5)  // the wait
  }
}

// ---------------------------------------------------------------------------
// fp32 products: CUDA cores
// ---------------------------------------------------------------------------

// The shape of an fp32 cluster for H: Uc units a CTA, CL CTAs (8 where the
// shared memory fits, else 16) and the shared memory: the resident weights
// [H][Uc] float4 (the G gates of a unit, padded to 4) and the h double
// buffer [2][H][16] fp32.  smem > kMaxSmem when neither fits.
struct FmaShape {
  int uc, cl;
  size_t smem;
};

inline FmaShape fma_shape(int H) {
  FmaShape s{0, 0, 0};
  for (int cl : {kMaxCluster, kMaxClusterNP}) {
    s.uc = (H + cl - 1) / cl;
    s.cl = (H + s.uc - 1) / s.uc;
    s.smem = (size_t)H * s.uc * sizeof(float4) +
             2 * (size_t)H * kFmaRows * sizeof(float);
    if (s.smem <= (size_t)kMaxSmem) break;
  }
  return s;
}

// acc[j][q] += h[row 4 rg + j, k] w[k, gate q of unit u] over k = ks, ks +
// KSN, ... < kend, in that order; four k at a time with all eight shared
// loads issued before the 64 FMAs, so that their latency overlaps.
template <int KSN>
__device__ __forceinline__ void fma_product(float (*acc)[4],
                                            const float4* w_s,
                                            const float* hcur, int uc, int u,
                                            int rg, int ks, int kend) {
  auto step = [&](const float4& wv, const float4& hv) {
    const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j][0] = fmaf(hr[j], wv.x, acc[j][0]);
      acc[j][1] = fmaf(hr[j], wv.y, acc[j][1]);
      acc[j][2] = fmaf(hr[j], wv.z, acc[j][2]);
      acc[j][3] = fmaf(hr[j], wv.w, acc[j][3]);
    }
  };
  auto hrow = [&](int k) {
    return *reinterpret_cast<const float4*>(hcur + (size_t)k * kFmaRows + 4 * rg);
  };
  int k = ks;
  for (; k + 3 * KSN < kend; k += 4 * KSN) {
    float4 wv[4], hv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wv[i] = w_s[(size_t)(k + i * KSN) * uc + u];
      hv[i] = hrow(k + i * KSN);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) step(wv[i], hv[i]);
  }
  for (; k < kend; k += KSN) step(w_s[(size_t)k * uc + u], hrow(k));
}

// Cluster (direction blockIdx.z, rows [16 blockIdx.y, +16)), CTA rank
// blockIdx.x.  kRound: h enters the product rounded to S (the LSTM training
// forward, the GRU); the LSTM eval forward multiplies the fp32 h.  cs: the
// LSTM training forward's cell states, else null.
template <class Cell, typename S, bool kRound>
__global__ void __launch_bounds__(kFmaThreads, 1)
    fwd_fma_kernel(const S* __restrict__ gx, const float* __restrict__ w,
                   S* __restrict__ ys, S* __restrict__ cs, int T, int B, int H,
                   int ndir, int uc) {
  constexpr int G = Cell::kGates;
  extern __shared__ float4 fwd_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int d = blockIdx.z, r0 = blockIdx.y * kFmaRows;
  const int own0 = rank * uc;
  const size_t gh = (size_t)G * H;
  float4* w_s = fwd_smem;  // [H][uc]
  float* hT = reinterpret_cast<float*>(w_s + (size_t)H * uc);  // [2][H][16]

  // resident, read along the units (coalesced), kLoadDepth / 4 entries of
  // four gates in flight a thread
  constexpr int kEntries = kLoadDepth / 4;
  for (int idx0 = tid; idx0 < H * uc; idx0 += kEntries * kFmaThreads) {
    float v[kEntries][4];
#pragma unroll
    for (int i = 0; i < kEntries; ++i) {
      const int idx = idx0 + i * kFmaThreads;
      const int k = idx / uc, unit = own0 + idx % uc;
      const bool ok = idx < H * uc && unit < H;
      const float* row = w + ((size_t)d * H + (ok ? k : 0)) * gh + (ok ? unit : 0);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[i][q] = ok && q < G ? row[(size_t)q * H] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kEntries; ++i) {
      const int idx = idx0 + i * kFmaThreads;
      if (idx < H * uc) w_s[idx] = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
  }
  for (int idx = tid; idx < 2 * H * kFmaRows; idx += kFmaThreads) hT[idx] = 0.f;

  // thread (item = (unit u, 4-row group rg), k slice ks), ksn slices a
  // power of two: a warp holds per = 32 / ksn items (units fastest, so that
  // the eight lanes of a shared-memory wavefront read eight adjacent units
  // of one k row, conflict-free) and ksn slices of each, lanes per apart.
  // After the product every lane of the item holds the item's sums, lane ks
  // does the gate math of rows j with j % ksn == ks, and the item stores
  // h_t to the peers p with p % ksn == ks.
  const int nrows = min(kFmaRows, B - r0);
  const int rgs = (nrows + 3) / 4;
  const int items = uc * rgs;
  int ksn = 1;
  while (ksn < 32 && items * ksn * 2 <= kFmaThreads) ksn *= 2;
  const int per = 32 / ksn, lane = tid & 31;
  const int ks = lane / per, item = (tid >> 5) * per + lane % per;
  const int base = lane % per;  // the item's lane of slice 0
  const bool active = item < items;
  const int u = active ? item % uc : 0, rg = active ? item / uc : 0;
  const int unit = own0 + u;
  const bool unit_ok = active && unit < H;
  const size_t lanes = (size_t)ndir * H;
  // the rows of this lane: slot r holds row j = ks + r ksn of the item
  // (slots r < 4 / ksn), so that every lane does the gate math of its own
  // rows at once, without divergence
  const int slots = ksn >= 4 ? 1 : 4 / ksn;
  auto mine = [&](int j) {
    return unit_ok && j < 4 && r0 + 4 * rg + j < B;
  };
  auto pick = [](const float* v, int j) {  // v[j], j in 0..3, no local memory
    return j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
  };

  float carry[4] = {0.f, 0.f, 0.f, 0.f}, nx[4][4];
  auto fetch = [&](int t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r >= slots) break;
      // rows this lane does not own read a clamped address, unused
      const int j = ks + r * ksn;
      const bool ok = mine(j);
      const S* p = gx + ((size_t)t * B + (ok ? r0 + 4 * rg + j : 0)) * ndir * gh +
                   d * gh + (ok ? unit : 0);
#pragma unroll
      for (int q = 0; q < G; ++q) nx[r][q] = load_f(p + (size_t)q * H);
    }
  };
  fetch(d == 0 ? 0 : T - 1);
  cluster.sync();  // every CTA of the cluster runs and holds its weights
  FWD_STAMP_START

  for (int s = 0; s < T; ++s) {
    const int t = d == 0 ? s : T - 1 - s;
    const float* hcur = hT + (size_t)(s & 1) * H * kFmaRows;
    float* hnxt = hT + (size_t)((s + 1) & 1) * H * kFmaRows;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int kend = active ? H : 0;
    switch (ksn) {
      case 1: fma_product<1>(acc, w_s, hcur, uc, u, rg, ks, kend); break;
      case 2: fma_product<2>(acc, w_s, hcur, uc, u, rg, ks, kend); break;
      case 4: fma_product<4>(acc, w_s, hcur, uc, u, rg, ks, kend); break;
      case 8: fma_product<8>(acc, w_s, hcur, uc, u, rg, ks, kend); break;
      case 16: fma_product<16>(acc, w_s, hcur, uc, u, rg, ks, kend); break;
      default: fma_product<32>(acc, w_s, hcur, uc, u, rg, ks, kend); break;
    }
    for (int off = per; off < 32; off *= 2)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[j][q] += __shfl_xor_sync(0xffffffffu, acc[j][q], off);
    FWD_STAMP(0)  // the product and the k-slice sums

    // h_t of each slot, as stored (hv) and as the next product reads it (hx)
    float hv[4] = {0.f, 0.f, 0.f, 0.f}, cv[4] = {0.f, 0.f, 0.f, 0.f};
    float hx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r >= slots) break;
      const int j = ks + r * ksn;
      float sums[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float col[4] = {acc[0][q], acc[1][q], acc[2][q], acc[3][q]};
        sums[q] = pick(col, j & 3);
      }
      if (!mine(j)) continue;
      hv[r] = cell_fwd(Cell{}, sums, nx[r], &carry[r], &cv[r]);
      hx[r] = kRound ? round_to(hv[r], ys) : hv[r];
    }
    FWD_STAMP(1)  // the gate math
    // the item's four rows into every lane of the item: row j is slot j /
    // ksn of lane base + per (j % ksn); then into the peers
    float h4v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h4v[j] = __shfl_sync(0xffffffffu, pick(hx, ksn >= 4 ? 0 : j / ksn),
                           base + per * (j & (ksn - 1)));
    const float4 h4 = make_float4(h4v[0], h4v[1], h4v[2], h4v[3]);
    if (unit_ok) {
      float* dst = hnxt + (size_t)unit * kFmaRows + 4 * rg;
      for (int p = ks; p < cl; p += ksn) st_cluster4(dst, p, h4);
    }
    FWD_STAMP(2)  // the DSMEM stores
    cluster_arrive();  // h_t is written
    FWD_STAMP(3)  // the release arrive
    if (s + 1 < T) fetch(d == 0 ? t + 1 : t - 1);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ks + r * ksn;
      if (r >= slots || !mine(j)) continue;
      const size_t o =
          ((size_t)t * B + r0 + 4 * rg + j) * lanes + (size_t)d * H + unit;
      store_f(ys + o, hv[r]);
      if (cs != nullptr) store_f(cs + o, cv[r]);
    }
    FWD_STAMP(4)  // the next loads and the global stores issued
    cluster_wait();  // every CTA's h_t is here, and h_{t-1} was read
    FWD_STAMP(5)  // the wait
  }
}

// ---------------------------------------------------------------------------
// fp32 products of the one-gate cell: four adjacent units to a float4
// ---------------------------------------------------------------------------

// The shape of a one-gate fp32 cluster for H: Uc units a CTA (a multiple of
// 4), CL CTAs (8 where the shared memory fits, else 16) and the shared
// memory: the resident weights [H][Uc / 4] float4 (four adjacent units) and
// the h double buffer [2][H][16] fp32.  smem > kMaxSmem when neither fits.
inline FmaShape fma1_shape(int H) {
  FmaShape s{0, 0, 0};
  for (int cl : {kMaxCluster, kMaxClusterNP}) {
    s.uc = ((H + cl - 1) / cl + 3) / 4 * 4;
    s.cl = (H + s.uc - 1) / s.uc;
    s.smem = (size_t)H * s.uc * sizeof(float) +
             2 * (size_t)H * kFmaRows * sizeof(float);
    if (s.smem <= (size_t)kMaxSmem) break;
  }
  return s;
}

// The k slices of an item of the one-gate fp32 kernel for B rows and Uc
// units a CTA: the most (a power of two up to 16) that kFmaThreads threads
// hold for the (quad, 4-row group) items of a full slice; 0 when the items
// alone outnumber the threads.
inline int fma1_slices(int B, int uc) {
  const int rows = B < kFmaRows ? B : kFmaRows;
  const int items = uc / 4 * ((rows + 3) / 4);
  if (items > kFmaThreads) return 0;
  int ksn = 1;
  while (ksn < 16 && items * ksn * 2 <= kFmaThreads) ksn *= 2;
  return ksn;
}

// two floats into the shared memory of CTA `rank` of the cluster
__device__ __forceinline__ void st_cluster2(float* p, int rank, float a,
                                            float b) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(s), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote),
               "f"(a), "f"(b)
               : "memory");
}

// Cluster (direction blockIdx.z, rows [16 blockIdx.y, +16)), CTA rank
// blockIdx.x, of the one-gate cell on fp32 streams: TanhCell (in = gx, out
// = ys) or TanhBwdCell (in = dy, y_in = the saved ys, out = dgx, walking
// time backward).  The layout is fwd_fma_kernel's with the float4 of a k
// row holding four adjacent units (Uc / 4 quads) in the place of the G
// gates of one unit: thread (item = (quad, 4-row group), k slice) sums its
// 4 rows x 4 units over its k slice with fma_product.  The KSN slices of an
// item then halve the 16 sums between them at each of log2(KSN) shuffle
// rounds (a reduce-scatter: 16 - 16 / KSN shuffles where a butterfly all-
// reduce takes 16 log2(KSN)), so each lane ends with M = 16 / KSN finished
// sums, unit-major (one unit's rows adjacent): it does their step, stores
// them and writes them into every peer's h buffer, a float4 (M >= 4), a
// float2 or a float a peer.
template <class Cell, int KSN>
__global__ void __launch_bounds__(kFmaThreads, 1)
    fma1_kernel(const float* __restrict__ in, const float* __restrict__ y_in,
                const float* __restrict__ w, float* __restrict__ out, int T,
                int B, int H, int ndir, int uc) {
  static_assert(Cell::kGates == 1, "one gate");
  constexpr int NI = kInPlanes<Cell>;
  constexpr int M = 16 / KSN;    // finished sums a lane
  constexpr int kPer = 32 / KSN;  // items a warp
  extern __shared__ float4 fwd_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31;
  const int d = blockIdx.z, r0 = blockIdx.y * kFmaRows;
  const int own0 = rank * uc, nq = uc / 4;
  float4* w_s = fwd_smem;  // [H][nq]
  float* hT = reinterpret_cast<float*>(w_s + (size_t)H * nq);  // [2][H][16]

  // resident, as floats w_f[k][u] = w(k, own0 + u): the forward's w_hh[d]
  // read along the units, the backward's w_hh[d]^T read along k (a row of
  // w_hh); kLoadDepth loads in flight a thread
  float* w_f = reinterpret_cast<float*>(w_s);
  const float* wd = w + (size_t)d * H * H;
  for (int idx0 = tid; idx0 < H * uc; idx0 += kLoadDepth * kFmaThreads) {
    float v[kLoadDepth];
#pragma unroll
    for (int i = 0; i < kLoadDepth; ++i) {
      const int idx = idx0 + i * kFmaThreads;
      const int k = kBackward<Cell> ? idx % H : idx / uc;
      const int unit = own0 + (kBackward<Cell> ? idx / H : idx % uc);
      v[i] = idx < H * uc && unit < H
                 ? wd[kBackward<Cell> ? (size_t)unit * H + k
                                      : (size_t)k * H + unit]
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoadDepth; ++i) {
      const int idx = idx0 + i * kFmaThreads;
      if (idx >= H * uc) continue;
      w_f[kBackward<Cell> ? (size_t)(idx % H) * uc + idx / H : (size_t)idx] = v[i];
    }
  }
  for (int idx = tid; idx < 2 * H * kFmaRows; idx += kFmaThreads) hT[idx] = 0.f;

  // thread (item, k slice ks): a warp holds kPer items (quads fastest, so
  // that a shared-memory wavefront reads adjacent quads of one k row) and
  // the KSN slices of each, kPer lanes apart
  const int nrows = min(kFmaRows, B - r0);
  const int items = nq * ((nrows + 3) / 4);
  const int ks = lane / kPer, item = (tid >> 5) * kPer + lane % kPer;
  const bool active = item < items;
  const int qd = active ? item % nq : 0, rg = active ? item / nq : 0;
  // sum o = 4 c + j is unit 4 qd + c, row 4 rg + j; this lane finishes
  // o0 .. o0 + M - 1 (round r keeps the upper half where bit r of ks is set)
  int o0 = 0;
#pragma unroll
  for (int r = 0; (1 << r) < KSN; ++r) o0 += ((ks >> r) & 1) * (8 >> r);
  const int unit0 = own0 + 4 * qd + o0 / 4;  // the lane's first unit
  const int row0 = r0 + 4 * rg;
  auto mine = [&](int i) {  // sum o0 + i inside H and B
    return active && unit0 + i / 4 < H && row0 + (o0 + i) % 4 < B;
  };
  const size_t lanes = (size_t)ndir * H;
  auto offset = [&](int t, int i) {  // clamped where not mine
    return mine(i) ? ((size_t)t * B + row0 + (o0 + i) % 4) * lanes +
                         (size_t)d * H + unit0 + i / 4
                   : (size_t)0;
  };

  float nx[M][NI];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const size_t o = offset(t, i);
      nx[i][0] = in[o];
      if constexpr (NI > 1) nx[i][1] = y_in[o];
    }
  };
  fetch(step_time<Cell>(0, d, T));
  cluster.sync();  // every CTA of the cluster runs and holds its weights
  FWD_STAMP_START

  for (int s = 0; s < T; ++s) {
    const int t = step_time<Cell>(s, d, T);
    const float* hcur = hT + (size_t)(s & 1) * H * kFmaRows;
    float* hnxt = hT + (size_t)((s + 1) & 1) * H * kFmaRows;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    fma_product<KSN>(acc, w_s, hcur, nq, qd, rg, ks, active ? H : 0);
    float v[16];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * c + j] = acc[j][c];
#pragma unroll
    for (int r = 0; (1 << r) < KSN; ++r) {
      const int half = 8 >> r;
      const bool upper = (ks >> r) & 1;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kPer << r);
      }
    }
    FWD_STAMP(0)  // the product and the reduce-scatter

    float hv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float unused;
      hv[i] = mine(i) ? cell_fwd(Cell{}, &v[i], nx[i], &unused, &unused) : 0.f;
    }
    FWD_STAMP(1)  // the step
    if (active) {
      float* dst = hnxt + (size_t)unit0 * kFmaRows + 4 * rg + o0 % 4;
#pragma unroll
      for (int c = 0; c < (M >= 4 ? M / 4 : 1); ++c) {
        if (unit0 + c >= H) break;
        for (int p = 0; p < cl; ++p) {
          if constexpr (M >= 4) {
            st_cluster4(dst + c * kFmaRows, p,
                        make_float4(hv[4 * c], hv[4 * c + 1], hv[4 * c + 2],
                                    hv[4 * c + 3]));
          } else if constexpr (M == 2) {
            st_cluster2(dst, p, hv[0], hv[1]);
          } else {
            st_cluster_b32(dst, p, __float_as_uint(hv[0]));
          }
        }
      }
    }
    FWD_STAMP(2)  // the DSMEM stores
    cluster_arrive();  // this step's values are written
    FWD_STAMP(3)  // the release arrive
    if (s + 1 < T) fetch(step_time<Cell>(s + 1, d, T));
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (mine(i)) out[offset(t, i)] = hv[i];
    FWD_STAMP(4)  // the next loads and the global stores issued
    cluster_wait();  // every CTA's values are here, and the last were read
    FWD_STAMP(5)  // the wait
  }
}

}  // namespace

#include "fwd_wide.cuh"  // the wide-batch fp32 branch, over the cells above

namespace {

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

template <typename S>
constexpr bool kIsBf16 = std::is_same<S, __nv_bfloat16>::value;

// the one-gate fp32 kernel with ksn k slices (fma1_slices)
template <class Cell>
const void* fma1_kernel_for(int ksn) {
  switch (ksn) {
    case 1: return reinterpret_cast<const void*>(fma1_kernel<Cell, 1>);
    case 2: return reinterpret_cast<const void*>(fma1_kernel<Cell, 2>);
    case 4: return reinterpret_cast<const void*>(fma1_kernel<Cell, 4>);
    case 8: return reinterpret_cast<const void*>(fma1_kernel<Cell, 8>);
    default: return reinterpret_cast<const void*>(fma1_kernel<Cell, 16>);
  }
}

// The forward's branch for the shape on the current device (FwdBranch).
// Products on bf16 operands (kRound with bf16 streams) take the mma
// kernel, 16 rows a cluster where all clusters fit, else 32, else (the
// gated cells) the wide kernel's bf16 form where its shape holds and its
// CTAs are all resident; fp32 products
// take the fma kernel (fma1_kernel for the one-gate cells) where all its
// 16-row clusters fit, else the wide kernel where its shape holds and its
// CTAs are all resident; every other shape the grid.  The tanh backward
// (TanhBwdCell) asks for its branch here too.  Asked of the runtime once
// per (device, B, H, ndir, kernel) and kept: every layer of every step asks
// again.
template <class Cell, typename S, bool kRound>
cudaError_t fwd_branch(int B, int H, int ndir, int* branch) {
  *branch = kFwdGrid;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  constexpr int kKind = Cell::kGates * 4 + (kIsBf16<S> ? 2 : 0) + (kRound ? 1 : 0);
  static std::mutex mu;
  static std::map<std::array<int, 5>, int> known;
  const std::array<int, 5> key = {device, B, H, ndir, kKind};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *branch = hit->second;
    return cudaSuccess;
  }
  int taken = kFwdGrid;
  bool fit = false;
  if constexpr (kRound && kIsBf16<S>) {
    const MmaShape m1 = mma_shape(Cell::kGates, H, 1);
    if (m1.uc <= 64) {
      err = clusters_fit(
          reinterpret_cast<const void*>(fwd_mma_kernel<Cell, 1>), m1.cl,
          (B + 15) / 16, ndir, m1.threads, m1.smem, &fit);
      if (err != cudaSuccess) return err;
      if (fit) {
        taken = kFwdMma16;
      } else {
        const MmaShape m2 = mma_shape(Cell::kGates, H, 2);
        err = clusters_fit(
            reinterpret_cast<const void*>(fwd_mma_kernel<Cell, 2>), m2.cl,
            (B + 31) / 32, ndir, m2.threads, m2.smem, &fit);
        if (err != cudaSuccess) return err;
        if (fit) taken = kFwdMma32;
      }
    }
    if constexpr (Cell::kGates > 1) {
      if (taken == kFwdGrid && !kParentBranches) {
        err = wide_fits<Cell, S, kRound>(B, H, ndir, &fit);
        if (err != cudaSuccess) return err;
        if (fit) taken = kFwdWideBf16;
      }
    }
  } else {
    if constexpr (Cell::kGates == 1) {
      static_assert(!kIsBf16<S> && kRound, "one gate, fp32 streams");
      const FmaShape f = fma1_shape(H);
      const int ksn = fma1_slices(B, f.uc);
      if (ksn > 0) {
        err = clusters_fit(fma1_kernel_for<Cell>(ksn), f.cl,
                           (B + kFmaRows - 1) / kFmaRows, ndir, kFmaThreads,
                           f.smem, &fit);
        if (err != cudaSuccess) return err;
        if (fit) taken = kFwdFma16;
      }
    } else {
      const FmaShape f = fma_shape(H);
      if (4 * f.uc <= kFmaThreads) {
        err = clusters_fit(
            reinterpret_cast<const void*>(fwd_fma_kernel<Cell, S, kRound>),
            f.cl, (B + kFmaRows - 1) / kFmaRows, ndir, kFmaThreads, f.smem,
            &fit);
        if (err != cudaSuccess) return err;
        if (fit) taken = kFwdFma16;
      }
    }
    if (taken == kFwdGrid && !kParentBranches) {
      err = wide_fits<Cell, S, kRound>(B, H, ndir, &fit);
      if (err != cudaSuccess) return err;
      if (fit) taken = kFwdWide;
    }
  }
  known[key] = taken;
  *branch = taken;
  return cudaSuccess;
}

// Launch the cluster branch `branch` (not the grid, not the wide branch)
// that fwd_branch chose.  cs: the LSTM training forward's cell states, else
// null.  The tanh
// backward (TanhBwdCell) passes dy as gx, dgx as ys and the saved ys as
// y_in.
template <class Cell, typename S, bool kRound>
cudaError_t launch_fwd_cluster(int branch, const void* gx, const void* w,
                               void* ys, void* cs, int T, int B, int H,
                               int ndir, cudaStream_t stream,
                               const void* y_in = nullptr) {
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaErrorInvalidValue;
  if constexpr (kRound && kIsBf16<S>) {
    auto aligned4 = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 4 == 0;
    };
    const int vec2 = H % 2 == 0 && aligned4(gx) && aligned4(ys) &&
                     (cs == nullptr || aligned4(cs)) &&
                     (y_in == nullptr || aligned4(y_in));
    const int km = branch == kFwdMma32 ? 2 : 1;
    const MmaShape m = mma_shape(Cell::kGates, H, km);
    const cudaLaunchConfig_t cfg = cluster_config(
        m.cl, (B + 16 * km - 1) / (16 * km), ndir, m.threads, m.smem, stream,
        attr);
    const auto* g = static_cast<const __nv_bfloat16*>(gx);
    const auto* yi = static_cast<const __nv_bfloat16*>(y_in);
    auto* y = static_cast<__nv_bfloat16*>(ys);
    auto* c = static_cast<__nv_bfloat16*>(cs);
    const auto* wf = static_cast<const float*>(w);
    if (branch == kFwdMma16)
      err = cudaLaunchKernelEx(&cfg, fwd_mma_kernel<Cell, 1>, g, yi, wf, y, c,
                               T, B, H, ndir, m.uc, m.ldk, vec2);
    else if (branch == kFwdMma32)
      err = cudaLaunchKernelEx(&cfg, fwd_mma_kernel<Cell, 2>, g, yi, wf, y, c,
                               T, B, H, ndir, m.uc, m.ldk, vec2);
  } else if constexpr (Cell::kGates == 1) {
    if (branch != kFwdFma16) return cudaErrorInvalidValue;
    const FmaShape f = fma1_shape(H);
    const int ksn = fma1_slices(B, f.uc);
    if (ksn == 0) return cudaErrorInvalidValue;
    const cudaLaunchConfig_t cfg =
        cluster_config(f.cl, (B + kFmaRows - 1) / kFmaRows, ndir,
                       kFmaThreads, f.smem, stream, attr);
    int uc = f.uc;
    void* args[] = {&gx, &y_in, &w, &ys, &T, &B, &H, &ndir, &uc};
    err = cudaLaunchKernelExC(&cfg, fma1_kernel_for<Cell>(ksn), args);
  } else {
    if (branch != kFwdFma16) return cudaErrorInvalidValue;
    const FmaShape f = fma_shape(H);
    const cudaLaunchConfig_t cfg =
        cluster_config(f.cl, (B + kFmaRows - 1) / kFmaRows, ndir,
                       kFmaThreads, f.smem, stream, attr);
    err = cudaLaunchKernelEx(&cfg, fwd_fma_kernel<Cell, S, kRound>,
                             static_cast<const S*>(gx),
                             static_cast<const float*>(w), static_cast<S*>(ys),
                             static_cast<S*>(cs), T, B, H, ndir, f.uc);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
