// The hoisted backward of the LSTM and GRU recurrences for Hopper (sm_90a),
// shared by lstm_bidir_train.cu and gru_bidir_train.cu: the gate pre-pass
// kernels (bf16 and fp32 streams, both on the tensor cores) and the two
// cluster kernels of the serial chain (bf16 streams on the tensor cores,
// and fp32 streams on the CUDA cores).
//
// Port of the hoisted backward of the JAX package
// (ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py:_lstm_prepass and its step,
// gru_pallas_v2.py:_make_bwd_kernel's pre-pass and step).  Everything in a
// backward step that waits on no carry -- the recompute product h_prev @
// w_hh, the transcendentals and the gate Jacobians -- is one fully parallel
// launch over (t, b, direction) that folds them into fp32 factor planes,
// (ndir, T, P, B, Hp) with Hp = H rounded up to a multiple of 4:
//   LSTM, P = 6:  A = o(1 - tc^2), Gi = g i(1 - i), Gf = c_prev f(1 - f),
//                 Gg = i(1 - g^2), Go = tc o(1 - o), F = f
//   GRU,  P = 5:  P_r = p_n hh_n r(1 - r), P_z = (h_prev - n) z(1 - z),
//                 P_n = p_n = (1 - z)(1 - n^2), P_hn = p_n r, Z = z
// indexed by forward time.  h_prev(t) is the saved row of ys at t - 1 for
// direction 0 and t + 1 for direction 1, zero outside.  The serial chain
// then keeps only the carry-dependent multiplies and dh = round_S(dpre) @
// w_hh^T (the GRU adds dh_t Z).
//
// Pre-pass: a (T B, H) x (H, nH) product per direction, gx and the saved
// planes in, the planes out.  Every gate of a (row, unit) pair lands in
// one thread's accumulators (n8 tile 2 q + s of a warp is gate q of its
// units [8 s, 8 s + 8)), so the epilogue is fused; each thread stores two
// adjacent units of a plane at once.
//
// bf16 streams, prepass_mma_kernel: a CTA owns 64 (t, b) rows and 16
// hidden units with all their gate columns; mma.sync m16n8k16 on ldmatrix
// fragments, bf16 operands (the saved ys and w_hh^T rounded to bf16), fp32
// sums, the epilogue's inputs loaded before the product.  Its bound is the
// bytes: 24 GFLOP but 286 MB at T=80, B=128, H=384.
//
// fp32 streams, prepass_tf32_kernel (replacing, with the bf16 kernel, the
// pre-pass of the JAX package's backward Pallas kernels:
// ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py:203 _lstm_prepass, called
// from the pallas_call at :478, and the pre-pass of gru_pallas_v2.py:
// _make_bwd_kernel, :228-239, in the pallas_call at :382).  What bounds it
// at T=80, B=128, H=384, two directions: 24.2 GFLOP and 382 MB (gx 126
// MB, ys and cs 63 MB, w_hh 4.7 MB read; the six planes, 189 MB, written,
// read once more by the serial kernel): 0.114 ms of bytes at 3.35 TB/s,
// 0.361 ms of fp32 FMA at 67 TFLOP/s, 0.146 ms for three TF32 passes at
// 495 TFLOP/s; at the recipe's (100, 8, 384) 1.89 GFLOP and 34 MB.  So
// the product runs on the tensor cores in 3xTF32, as the wide kernels'
// do: both operands split into hi = x rounded to TF32 and lo = x - hi
// (which the tensor core reads truncated to TF32), lo hi + hi lo + hi hi
// summed in fp32 a k step at a time in order (mma.sync m16n8k8; a single
// TF32 pass misses the card's fp32 tolerance, 1e-4).  A warp owns 32 rows
// and 16 units (2 x 2 G tiles of m16n8, each A fragment serving 2 G tiles
// and each B fragment two), a CTA 4 x 2 warps: 128 rows x 32 units.
// Staging is asynchronous: a ring of three k slots of 32, the next two in
// flight behind the one multiplied (105 KB, the GRU's 93 KB, so that two
// of the GRU's CTAs fit an SM; a fourth slot was no faster for the LSTM
// and 1.4x slower at the GRU's bench shape), each thread's 16-byte
// cp.async chunks (4-byte copies where H % 4 != 0 or a row start is not
// 16-byte aligned, which the kernel itself chooses) of ys rows as
// [row][k] and of w_hh rows as [k][column] -- both as they lie in memory,
// so the weights need no transposed copy a call, and both tiles' strides
// keep the fragments' 4-byte shared loads free of bank conflicts.  The
// warps split the fragments they load in registers: a first version
// split each element once a CTA, in place after its copy landed, which
// costs a pass over each slot and a second plane of lo values, so twice
// the fragment loads from shared memory, and it measured slower on an H100
// at all seven of the main paths' shapes.  Smaller CTAs (64 x 32, 64 x 16,
// and 128 x 16 two CTAs an SM), which spread the recipe's 800 and the
// data-parallel rank's 400 rows over more SMs, ranged on the device from
// 9% faster (128 x 16 at the recipe's batch of 8) to 10% slower at B <= 8
// and from as fast to 47% slower at B >= 64, so the kernel keeps one tile
// (tools/probe_prepass_tiles.py).
// The epilogue's inputs (gx, cs at t and t -/+ 1, the GRU's ys at t -/+ 1)
// are loaded after the product.  No atomics, no split of k: a graph
// replay equals the eager call bit for bit.
//
// Serial chain: one thread-block cluster per (direction, slice of batch
// rows); the recurrence couples only the hidden units of one batch row in
// one direction, so clusters never meet and the launch is not cooperative.
// CTA r owns Uc units (a multiple of 4) and all their gate columns, and
// keeps resident in shared memory the rows of w_hh that its columns meet:
// w_hh[unit', q H + r Uc + u] for every unit'.  Per step a CTA forms dpre
// for its (row, unit) pairs from the planes and multiplies its dpre slice
// with the resident rows: the partial dh of ALL units from its own gate
// columns (a split of the contraction, so dpre never leaves the CTA).  It
// writes each peer's Uc-wide share of that partial (rows x Uc units, fp32)
// into the peer's shared memory (distributed shared memory,
// st.shared::cluster of 4 floats), and each CTA sums the CL partials it
// received, in rank order (deterministic: a graphed call equals the eager
// one bit for bit), into dh.  A split of the units instead would gather
// the whole rows x 4H dpre into every CTA beside its weights: at B = 8, H
// = 384 a CTA of a cluster of 16 sends 11.5 KB of partials a step, where
// the gather would bring 49 KB into each CTA.
//
// bwd_cluster_kernel, bf16 streams (branches cluster16, cluster32): CL <=
// 8 CTAs, Uc = ceil(H / 8) rounded up to 4, the resident rows bf16 and the
// product on the tensor cores (the rounded dpre slice by ws).  What a step
// costs (tools/probe_bwd_steps.py on an H100: clock64 stamps of one thread,
// LSTM H = 384, 16 rows, ~10k cycles): the product (~2.6k), the DSMEM
// writes (~2.4k for 24 KB, about 10 bytes a clock per SM), the receive sum
// (~1.2k) and the cluster barriers (~2.1k: the release arrive ~1.2k, the
// waits and the read arrive ~0.9k).  Only 15 clusters of 8 one-CTA-per-SM
// blocks fit on a 132-SM H100 at once, so where 16-row clusters would run
// in two waves (B = 128 with two directions) the launcher takes 32-row
// clusters (two m16 tiles sharing each weight fragment).  It takes bf16
// streams while its shared memory fits (LSTM H <= 416, GRU H <= 480).
//
// bwd_fma_kernel, fp32 streams (branch cluster16_fp32; the LSTM recipes'
// batch of 8 and the data-parallel ranks' 4, the GRU at B = 8): 16 rows a
// cluster,
// fp32 FMA on CUDA cores (fp32 parity, no TF32).  fp32 w_hh at H = 384 is
// 2.36 MB a direction: 295 KB a CTA in a cluster of 8, so the kernel takes a
// 16-CTA cluster (non-portable; Uc = 24, 147 KB a CTA) where 8 does not fit,
// as the fp32 forward does (fwd_fma_kernel); at H = 256 (mfcc_39) a cluster
// of 8 holds it (Uc = 32, 131 KB).  Shared memory: the resident rows as
// ws[k][n] (k the CTA's 4 Uc gate columns, n all H units padded to 4, a
// float4 holding four adjacent units), dpre transposed as [k][16 rows + 4]
// (the 4 floats of padding make the rows of 8 adjacent k hit 8 distinct
// bank quads) and the receive buffer [CL][16][Uc].  Bound: all three
// within 227 KB: H <= 308 at CL = 8, H <= 432 at CL = 16.  The product is
// bound by shared-memory wavefronts before FMAs (as the fp32 forward's
// is), so thread (item = quad of four output units, k slice) keeps
// the sums of all the slice's rows (4 units x 16 rows): one float4 of
// weights serves every row, and the rows' dpre float4 is one address for
// every lane of a slice (a broadcast).  Items are a warp's fastest index,
// KSN k slices (a power of two, up to 8, with up to 384 threads) are
// kPer = 32 / KSN lanes apart and summed by a reduce-scatter of shuffles
// that leaves lane ks the rows ks, ks + KSN, ...: each lane then writes its
// rows' float4 into the one peer that owns the quad.  Rows past B are
// neither multiplied, exchanged nor stored, and where B <= 8 the sums hold
// 8 rows, not 16 (123-125 registers a thread, not 157).  What a step costs
// (tools/probe_bwd_steps.py on an H100, B = 8, H = 384, clusters of 16:
// ~10k cycles with the stamps, 4.3 us without): the product and the
// reduce-scatter ~5.2k (57 FMAs a clock of the SM's 128), the release
// arrive ~1.05k, the CTA barrier ~0.8k, the receive sum of 16 partials
// ~0.7k, the DSMEM writes ~0.55k, the element-wise step ~0.5k.
// The GRU runs the same kernel with three gate columns a unit: the planes
// [P_r | P_z | P_n | P_hn | Z], dgx = [dpre_r | dpre_z | dpre_n] and dhhn =
// dh_t P_hn stored before the product, the product over [dpre_r, dpre_z,
// dhh_n] (a CTA's 3 Uc columns padded with zeros to Kp, a multiple of 16,
// for the two-k steps of its slices) and the local dh_t Z added to the
// receive sum, after it, by the unit's owner (cell_step).  At H = 256 the
// rows of 3 Uc columns fit a cluster of 8 (Uc = 32, Kp = 96, 122 KB a CTA
// with dpre^T and the receive buffer).  Bound: H <= 344 at CL = 8, H <= 500
// at CL = 16.
//
// Per step, both kernels keep the barrier count at one round trip and a
// half: one receive buffer, and a relaxed "read" arrive that lets peers
// refill it while this CTA forms dpre; the release arrive that publishes
// the data is not held up by global stores (bwd_cluster_kernel stores dgx
// after it, bwd_fma_kernel before its product, which they have long
// drained by then, so that dpre holds no registers through the product);
// the next step's planes and dy are loaded during the product.  The
// launcher's choice is asked of the CUDA runtime once per device and shape
// (cluster_branch): a cluster branch only where its shared memory fits and
// all of the launch's clusters can be resident at once.
//
// fp32 streams where the fp32 cluster's clusters do not all fit at once (B
// >= 64 at H = 384: 8 or 16 clusters of 16 CTAs) or its weights do not fit
// take the wide branch of bwd_wide.cuh (kBwdWide: one persistent
// cooperative CTA an SM, the rows of w_hh that its gate columns meet
// resident, the product in 3xTF32 on the tensor cores, the partial dh
// exchanged through L2 under per-writer step flags) where its shape holds.
// Everything else -- H past the bounds -- takes the grid branch: the
// persistent cooperative grid kernel of each source, reading the same
// planes.  The launcher reports which branch it took.

#pragma once

#include <array>
#include <cstdint>
#include <map>
#include <mutex>
#include <type_traits>

#include "lstm_fwd.cuh"

namespace {

constexpr int kPreRows = 64;   // (t, b) rows of a pre-pass tile
constexpr int kPreUnits = 16;  // hidden units of a pre-pass tile
constexpr int kPreK = 32;      // k depth of a staged pre-pass tile
constexpr int kPreLd = kPreK + 8;  // bf16 row stride: conflict-free fragments
constexpr int kSlice = 16;         // batch rows of a cluster (one mma M tile)
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxClusterNP = 16;  // non-portable cluster size
constexpr int kLoadDepth = 16;  // weight loads in flight a thread at the start
constexpr int kMaxNtw = 8;         // step-product n-tiles per warp (H <= 512)
constexpr int kClusterThreads = 256;

struct LstmCell {
  static constexpr int kGates = 4;
  static constexpr int kPlanes = 6;
};
struct GruCell {
  static constexpr int kGates = 3;
  static constexpr int kPlanes = 5;
};

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// d += a * b, one m16n8k16 tile: bf16 operands, fp32 sums.  Not volatile:
// it only computes, so the compiler may interleave it with the loads.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes each, 16-byte aligned).
__device__ __forceinline__ void ldsm_x4(unsigned* r, const unsigned short* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// The A fragment of rows [0, 16) x k [k0, k0 + 16) of a row-major bf16 tile
// with row stride ld.
__device__ __forceinline__ void ldsm_a(unsigned* a, const unsigned short* tile,
                                       int ld, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4(a, tile + (8 * (mi & 1) + r) * ld + k0 + 8 * (mi >> 1));
}

// The B fragments (b0, b1 of n-tile n0 / 8, then of the next) of rows
// [n0, n0 + 16) x k [k0, k0 + 16) of an n-major bf16 tile with row stride ld.
__device__ __forceinline__ void ldsm_b2(unsigned* b, const unsigned short* tile,
                                        int ld, int n0, int k0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4(b, tile + (size_t)(n0 + 8 * (mi >> 1) + r) * ld + k0 + 8 * (mi & 1));
}

// h_prev(t)'s time index in direction d, or -1 outside [0, T)
__device__ __forceinline__ int prev_time(int t, int d, int T) {
  const int tp = d == 0 ? t - 1 : t + 1;
  return tp < T ? tp : -1;
}

// 8 consecutive bf16 of a row as raw bits, zero past n valid entries; one
// 16-byte load when vec (the row and k are 16-byte aligned).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int n,
                                       bool vec) {
  if (vec && n >= 8) return *reinterpret_cast<const uint4*>(p);
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned short v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < n ? q[j] : 0;
  return make_uint4(v[0] | (unsigned)v[1] << 16, v[2] | (unsigned)v[3] << 16,
                    v[4] | (unsigned)v[5] << 16, v[6] | (unsigned)v[7] << 16);
}

// 2 consecutive bf16 as raw bits, zero past n valid entries; one 4-byte load
// when vec.
__device__ __forceinline__ unsigned load2(const __nv_bfloat16* p, int n,
                                          bool vec) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  if (vec && n >= 2) return *reinterpret_cast<const unsigned*>(q);
  return (n > 0 ? q[0] : 0u) | (n > 1 ? (unsigned)q[1] << 16 : 0u);
}
__device__ __forceinline__ float lo_f(unsigned v) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(v & 0xffff)));
}
__device__ __forceinline__ float hi_f(unsigned v) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(v >> 16)));
}

// ---------------------------------------------------------------------------
// pre-pass kernel, bf16 streams: tensor cores
// ---------------------------------------------------------------------------

// What the epilogue of one (row, unit pair) reads besides the products: the
// gate inputs of both units and, per cell, c_t and c_prev (LSTM) or h_prev
// (GRU), as packed bf16 pairs; loaded before the product so that their
// latency hides behind it.
template <class Cell>
struct PairInputs {
  unsigned gx[Cell::kGates];
  unsigned extra[2];
};

// The planes of two adjacent units (unit, unit + 1) of one (t, b) from
// their products hh[q][e]; stored as float2 (rows of the planes are padded
// to a multiple of 4, so unit + 1 < Hp).
__device__ __forceinline__ void emit_pair(LstmCell, const PairInputs<LstmCell>& in,
                                          const float (*hh)[2], float* out,
                                          size_t ps) {
  float v[LstmCell::kPlanes][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    auto pick = [&](unsigned x) { return e ? hi_f(x) : lo_f(x); };
    const float ig = sigmoid_f(pick(in.gx[0]) + hh[0][e]);
    const float fg = sigmoid_f(pick(in.gx[1]) + hh[1][e]);
    const float gg = tanhf(pick(in.gx[2]) + hh[2][e]);
    const float og = sigmoid_f(pick(in.gx[3]) + hh[3][e]);
    const float tc = tanhf(pick(in.extra[0]));
    const float c_prev = pick(in.extra[1]);
    v[0][e] = og * (1.0f - tc * tc);
    v[1][e] = gg * (ig * (1.0f - ig));
    v[2][e] = c_prev * (fg * (1.0f - fg));
    v[3][e] = ig * (1.0f - gg * gg);
    v[4][e] = tc * (og * (1.0f - og));
    v[5][e] = fg;
  }
#pragma unroll
  for (int p = 0; p < LstmCell::kPlanes; ++p)
    *reinterpret_cast<float2*>(out + p * ps) = make_float2(v[p][0], v[p][1]);
}

__device__ __forceinline__ void emit_pair(GruCell, const PairInputs<GruCell>& in,
                                          const float (*hh)[2], float* out,
                                          size_t ps) {
  float v[GruCell::kPlanes][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    auto pick = [&](unsigned x) { return e ? hi_f(x) : lo_f(x); };
    const float rg = sigmoid_f(pick(in.gx[0]) + hh[0][e]);
    const float zg = sigmoid_f(pick(in.gx[1]) + hh[1][e]);
    const float hh_n = hh[2][e];
    const float ng = tanhf(pick(in.gx[2]) + rg * hh_n);
    const float hp = pick(in.extra[0]);
    const float p_n = (1.0f - zg) * (1.0f - ng * ng);
    v[0][e] = p_n * hh_n * (rg * (1.0f - rg));
    v[1][e] = (hp - ng) * (zg * (1.0f - zg));
    v[2][e] = p_n;
    v[3][e] = p_n * rg;
    v[4][e] = zg;
  }
#pragma unroll
  for (int p = 0; p < GruCell::kPlanes; ++p)
    *reinterpret_cast<float2*>(out + p * ps) = make_float2(v[p][0], v[p][1]);
}

// CTA (m-tile, unit group, direction), 4 warps; warp w owns tile rows
// [16 w, 16 w + 16) and every column: column j of the tile is gate j / 16 of
// unit u0 + j % 16.  wt is w_hh^T (ndir, G H, H) bf16, the transposed
// weights rounded to bf16, so both operands stage as 16-byte rows.
template <class Cell>
__global__ void __launch_bounds__(128, 4)
    prepass_mma_kernel(const __nv_bfloat16* __restrict__ gx,
                       const __nv_bfloat16* __restrict__ wt,
                       const __nv_bfloat16* __restrict__ ys,
                       const __nv_bfloat16* __restrict__ cs,
                       float* __restrict__ planes, int T, int B, int H, int Hp,
                       int ndir, int vec8, int vec2) {
  constexpr int G = Cell::kGates;
  constexpr bool kLstm = G == LstmCell::kGates;
  constexpr int kCols = G * kPreUnits;
  constexpr int kNt = kCols / 8;                       // n-tiles of a warp
  constexpr int kBChunks = (kCols * kPreK / 8 + 127) / 128;  // per thread
  __shared__ __align__(16) unsigned short as[2][kPreRows][kPreLd];
  __shared__ __align__(16) unsigned short bs[2][kCols][kPreLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int d = blockIdx.z;
  const int u0 = blockIdx.y * kPreUnits;
  const int m0 = blockIdx.x * kPreRows;
  const int M = T * B;
  const size_t gh = (size_t)G * H;
  const size_t lanes = (size_t)ndir * H;
  const int n_kt = (H + kPreK - 1) / kPreK;

  // the epilogue's inputs: rows g, g + 8 of the warp, unit pairs s
  PairInputs<Cell> pin[2][2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int m = m0 + 16 * warp + g + 8 * ri;
    const int t = m < M ? m / B : 0, b = m < M ? m % B : 0;
    const int tp = prev_time(t, d, T);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int unit = u0 + 8 * s + 2 * c;
      const int n = m < M ? H - unit : 0;  // valid units from here
      const __nv_bfloat16* gp = gx + ((size_t)t * B + b) * ndir * gh + d * gh + unit;
#pragma unroll
      for (int q = 0; q < G; ++q) pin[ri][s].gx[q] = load2(gp + (size_t)q * H, n, vec2);
      const size_t o_t = ((size_t)t * B + b) * lanes + (size_t)d * H + unit;
      const size_t o_p = ((size_t)(tp < 0 ? 0 : tp) * B + b) * lanes + (size_t)d * H + unit;
      if constexpr (kLstm) {
        pin[ri][s].extra[0] = load2(cs + o_t, n, vec2);
        pin[ri][s].extra[1] = load2(cs + o_p, tp < 0 ? 0 : n, vec2);
      } else {
        pin[ri][s].extra[0] = load2(ys + o_p, tp < 0 ? 0 : n, vec2);
        pin[ri][s].extra[1] = 0;
      }
    }
  }

  uint4 ra[2], rb[kBChunks];
  auto fetch = [&](int kt) {
    const int k0 = kt * kPreK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * 128;
      const int r = e >> 2, k = k0 + 8 * (e & 3);
      const int m = m0 + r;
      int tp = -1, b = 0;
      if (m < M) {
        b = m % B;
        tp = prev_time(m / B, d, T);
      }
      ra[i] = tp >= 0 && k < H
                  ? load8(ys + ((size_t)tp * B + b) * lanes + (size_t)d * H + k,
                          H - k, vec8)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int e = tid + i * 128;
      const int j = e >> 2, k = k0 + 8 * (e & 3);
      const int unit = u0 + j % kPreUnits;
      rb[i] = e < kCols * 4 && unit < H && k < H
                  ? load8(wt + ((size_t)d * gh + (size_t)(j / kPreUnits) * H +
                                unit) * H + k,
                          H - k, vec8)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * 128;
      *reinterpret_cast<uint4*>(&as[buf][e >> 2][8 * (e & 3)]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int e = tid + i * 128;
      if (e < kCols * 4)
        *reinterpret_cast<uint4*>(&bs[buf][e >> 2][8 * (e & 3)]) = rb[i];
    }
  };

  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  fetch(0);
  put(0);
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) fetch(kt + 1);
#pragma unroll
    for (int ks = 0; ks < kPreK / 16; ++ks) {
      unsigned a[4], bf[kNt / 2][4];
      ldsm_a(a, &as[buf][16 * warp][0], kPreLd, 16 * ks, lane);
#pragma unroll
      for (int n = 0; n < kNt / 2; ++n)
        ldsm_b2(bf[n], &bs[buf][0][0], kPreLd, 16 * n, 16 * ks, lane);
#pragma unroll
      for (int n = 0; n < kNt; ++n)
        mma_bf16(acc[n], a, bf[n / 2][2 * (n & 1)], bf[n / 2][2 * (n & 1) + 1]);
    }
    if (kt + 1 < n_kt) put(buf ^ 1);
    __syncthreads();
  }

  // thread's entries: rows g, g + 8 of the warp's 16; unit pairs 8 s + 2 c;
  // gate q of unit half s is n-tile 2 q + s
  const size_t ps = (size_t)B * Hp;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int m = m0 + 16 * warp + g + 8 * ri;
    if (m >= M) continue;
    const int t = m / B, b = m % B;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int unit = u0 + 8 * s + 2 * c;
      if (unit >= H) continue;
      float hh[G][2];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        hh[q][0] = acc[2 * q + s][2 * ri];
        hh[q][1] = acc[2 * q + s][2 * ri + 1];
      }
      emit_pair(Cell{}, pin[ri][s], hh,
                planes + (((size_t)d * T + t) * Cell::kPlanes * B + b) * Hp + unit,
                ps);
    }
  }
}

// ---------------------------------------------------------------------------
// pre-pass kernel, fp32 streams: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// hi: x rounded to tf32 to nearest with ties away from zero
// (cvt.rna.tf32.f32 on finite values); lo: x - hi, whose low 13 bits the
// tensor core does not read.  Shared with the wide kernels (bwd_wide.cuh,
// fwd_wide.cuh).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 tile: tf32 operands, fp32 sums
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4-byte global -> shared copy through L1; zero-fills when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// The tile of prepass_tf32_kernel: a warp owns kTfWarpRows (t, b) rows (two
// m16 tiles) and kTfWarpUnits units with all their gate columns (2 G n8
// tiles); a CTA is kTfWarpsM x kTfWarpsU warps, 128 rows x 32 units.
constexpr int kTfWarpRows = 32;
constexpr int kTfWarpUnits = 16;
constexpr int kTfWarpsM = 4;
constexpr int kTfWarpsU = 2;
constexpr int kTfK = 32;          // k depth of a ring slot
constexpr int kTfStages = 3;      // ring slots: two in flight past the one used
constexpr int kTfLdA = kTfK + 4;  // A row stride, floats
constexpr int kTfPadB = 8;        // B row padding, floats

template <class Cell>
struct TfTile {
  static constexpr int kThreads = 32 * kTfWarpsM * kTfWarpsU;
  static constexpr int kRows = kTfWarpRows * kTfWarpsM;
  static constexpr int kUnits = kTfWarpUnits * kTfWarpsU;
  static constexpr int kCols = Cell::kGates * kUnits;
  static constexpr int kLdB = kCols + kTfPadB;
  static constexpr int kSlotA = kRows * kTfLdA;  // floats of the A tile
  static constexpr int kSlotB = kTfK * kLdB;     // floats of the B tile
  static constexpr int kSlot = kSlotA + kSlotB;  // a slot: A, then B
  static constexpr size_t kSmem = (size_t)kTfStages * kSlot * sizeof(float);
  static constexpr int kAChunksRow = kTfK / 4;   // 16-byte chunks a row
  static constexpr int kAPer = kRows * kAChunksRow / kThreads;  // exact
  static constexpr int kBChunksRow = kCols / 4;
  static constexpr int kBPer = (kTfK * kBChunksRow + kThreads - 1) / kThreads;
};

// The planes of two adjacent units (unit, unit + 1) of one (t, b) from
// their products hh[q][e], the gate inputs gv[q][e] and ev: c_t and c_prev
// (LSTM) or h_prev (GRU); the same formulas as emit_pair.
__device__ __forceinline__ void emit_pair_f32(LstmCell, const float (*gv)[2],
                                              const float (*ev)[2],
                                              const float (*hh)[2],
                                              float (*v)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float ig = sigmoid_f(gv[0][e] + hh[0][e]);
    const float fg = sigmoid_f(gv[1][e] + hh[1][e]);
    const float gg = tanhf(gv[2][e] + hh[2][e]);
    const float og = sigmoid_f(gv[3][e] + hh[3][e]);
    const float tc = tanhf(ev[0][e]);
    const float c_prev = ev[1][e];
    v[0][e] = og * (1.0f - tc * tc);
    v[1][e] = gg * (ig * (1.0f - ig));
    v[2][e] = c_prev * (fg * (1.0f - fg));
    v[3][e] = ig * (1.0f - gg * gg);
    v[4][e] = tc * (og * (1.0f - og));
    v[5][e] = fg;
  }
}

__device__ __forceinline__ void emit_pair_f32(GruCell, const float (*gv)[2],
                                              const float (*ev)[2],
                                              const float (*hh)[2],
                                              float (*v)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float rg = sigmoid_f(gv[0][e] + hh[0][e]);
    const float zg = sigmoid_f(gv[1][e] + hh[1][e]);
    const float hh_n = hh[2][e];
    const float ng = tanhf(gv[2][e] + rg * hh_n);
    const float hp = ev[0][e];
    const float p_n = (1.0f - zg) * (1.0f - ng * ng);
    v[0][e] = p_n * hh_n * (rg * (1.0f - rg));
    v[1][e] = (hp - ng) * (zg * (1.0f - zg));
    v[2][e] = p_n;
    v[3][e] = p_n * rg;
    v[4][e] = zg;
  }
}

// n valid floats (n <= 2) at p, zero past them; one 8-byte load when vec
__device__ __forceinline__ void load_pair(float* out, const float* p, int n,
                                          bool vec) {
  if (vec && n >= 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = n > 0 ? p[0] : 0.f;
    out[1] = n > 1 ? p[1] : 0.f;
  }
}

// CTA (m-tile, unit group, direction) of kTfWarpsM x kTfWarpsU warps; warp
// (wm, wu) owns tile rows [32 wm, 32 wm + 32) and units [16 wu, 16 wu +
// 16) of the tile.  Shared memory is a ring of kTfStages slots of kTfK;
// A is the tile's rows of h_prev (ys at t -/+ 1, zero at the sequence
// ends) as [row][k], B the tile's gate columns of w_hh as [k][column],
// column q kUnits + u = gate q of unit u0 + u, both as they lie in global
// memory (k-contiguous rows of ys, unit-contiguous rows of w_hh).  Each
// thread copies its 16-byte chunks of a slot with cp.async (4-byte copies
// where vec4 is 0); one barrier a slot.  Each warp splits the fragments it
// loads into hi and lo in registers.  A warp's accumulators hold, for each
// of its two m16 tiles, n8 tile 2 q + s = gate q of units [8 s, 8 s + 8)
// of its 16, so that lane (g, c) finds every gate of units 8 s + 2 c and 8
// s + 2 c + 1 for rows g and g + 8 in its registers.
template <class Cell>
__global__ void __launch_bounds__(TfTile<Cell>::kThreads)
    prepass_tf32_kernel(const float* __restrict__ gx,
                        const float* __restrict__ w,
                        const float* __restrict__ ys,
                        const float* __restrict__ cs,
                        float* __restrict__ planes, int T, int B, int H,
                        int Hp, int ndir, int vec4, int vec2) {
  using Tile = TfTile<Cell>;
  constexpr int G = Cell::kGates;
  constexpr bool kLstm = G == LstmCell::kGates;
  constexpr int kNt = 2 * G;  // n8 tiles of a warp
  constexpr int kTh = Tile::kThreads;
  extern __shared__ __align__(16) float tf_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp % kTfWarpsM, wu = warp / kTfWarpsM;
  const int d = blockIdx.z;
  const int m0 = blockIdx.x * Tile::kRows;
  const int u0 = blockIdx.y * Tile::kUnits;
  const int M = T * B;
  const size_t gh = (size_t)G * H;
  const size_t lanes = (size_t)ndir * H;
  const int n_kt = (H + kTfK - 1) / kTfK;

  // this thread's chunks: A rows (their h_prev row, null where zero) and
  // B columns, the same in every k tile
  const float* arow[Tile::kAPer];
  int aoff[Tile::kAPer];
#pragma unroll
  for (int i = 0; i < Tile::kAPer; ++i) {
    const int e = tid + i * kTh;
    const int r = e / Tile::kAChunksRow, m = m0 + r;
    arow[i] = nullptr;
    if (m < M) {
      const int b = m % B, tp = prev_time(m / B, d, T);
      if (tp >= 0) arow[i] = ys + ((size_t)tp * B + b) * lanes + (size_t)d * H;
    }
    aoff[i] = r * kTfLdA + 4 * (e % Tile::kAChunksRow);
  }
  int bcol[Tile::kBPer], bkk[Tile::kBPer], bunit[Tile::kBPer];
#pragma unroll
  for (int i = 0; i < Tile::kBPer; ++i) {
    const int e = tid + i * kTh;
    const int j = 4 * (e % Tile::kBChunksRow);
    bkk[i] = e / Tile::kBChunksRow;  // >= kTfK: no chunk
    bunit[i] = u0 + j % Tile::kUnits;
    bcol[i] = (j / Tile::kUnits) * H + bunit[i];
  }
  const float* wd = w + (size_t)d * H * gh;

  auto fetch = [&](int kt, int slot) {
    float* s = tf_smem + slot * Tile::kSlot;
    const int k0 = kt * kTfK;
#pragma unroll
    for (int i = 0; i < Tile::kAPer; ++i) {
      const int k = k0 + 4 * ((tid + i * kTh) % Tile::kAChunksRow);
      float* dst = s + aoff[i];
      if (vec4) {
        const bool ok = arow[i] != nullptr && k < H;
        cp_async16(dst, ok ? arow[i] + k : ys, ok);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool ok = arow[i] != nullptr && k + x < H;
          cp_async4(dst + x, ok ? arow[i] + k + x : ys, ok);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Tile::kBPer; ++i) {
      if (bkk[i] >= kTfK) continue;
      const int k = k0 + bkk[i];
      const int j = 4 * ((tid + i * kTh) % Tile::kBChunksRow);
      float* dst = s + Tile::kSlotA + bkk[i] * Tile::kLdB + j;
      const float* src = wd + (size_t)k * gh + bcol[i];
      if (vec4) {
        const bool ok = k < H && bunit[i] < H;
        cp_async16(dst, ok ? src : w, ok);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool ok = k < H && bunit[i] + x < H;
          cp_async4(dst + x, ok ? src + x : w, ok);
        }
      }
    }
  };
  float acc[2][kNt][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < kNt; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kTfStages - 1; ++st) {
    if (st < n_kt) fetch(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int slot = kt % kTfStages;
    cp_async_wait<kTfStages - 2>();  // this thread's copies of kt
    __syncthreads();  // everyone's copies of kt landed; slot kt - 1 free
    if (kt + kTfStages - 1 < n_kt)
      fetch(kt + kTfStages - 1, (kt + kTfStages - 1) % kTfStages);
    cp_async_commit();
    const float* sl = tf_smem + slot * Tile::kSlot;
    const float* ap = sl + (kTfWarpRows * wm + g) * kTfLdA + c;
    const float* bp = sl + Tile::kSlotA + c * Tile::kLdB + kTfWarpUnits * wu + g;
#pragma unroll
    for (int ks = 0; ks < kTfK / 8; ++ks) {
      // A fragments of both m16 tiles (rows g, g + 8; k c, c + 4), split
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = 16 * i * kTfLdA + 8 * ks;
        split_tf32(ap[o], ah[i][0], al[i][0]);
        split_tf32(ap[o + 8 * kTfLdA], ah[i][1], al[i][1]);
        split_tf32(ap[o + 4], ah[i][2], al[i][2]);
        split_tf32(ap[o + 8 * kTfLdA + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        // n8 tile n: gate n / 2 of units 8 (n % 2) .. of the warp's 16
        const int o = 8 * ks * Tile::kLdB + (n >> 1) * Tile::kUnits + 8 * (n & 1);
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(bp[o], bh0, bl0);
        split_tf32(bp[o + 4 * Tile::kLdB], bh1, bl1);
        // lo hi + hi lo + hi hi, in that order into each sum
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[i][n], al[i], bh0, bh1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[i][n], ah[i], bl0, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[i][n], ah[i], bh0, bh1);
      }
    }
  }

  // the epilogue: its inputs loaded after the product, two units a store
  const size_t ps = (size_t)B * Hp;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + kTfWarpRows * wm + 16 * i + 8 * r + g;
      if (m >= M) continue;
      const int t = m / B, b = m % B;
      const int tp = prev_time(t, d, T);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int unit = u0 + kTfWarpUnits * wu + 8 * s + 2 * c;
        if (unit >= H) continue;
        const int nv = H - unit;  // valid units from here
        float gv[G][2], ev[2][2], hh[G][2], v[Cell::kPlanes][2];
        const float* gp = gx + ((size_t)t * B + b) * ndir * gh + d * gh + unit;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          load_pair(gv[q], gp + (size_t)q * H, nv, vec2);
          hh[q][0] = acc[i][2 * q + s][2 * r];
          hh[q][1] = acc[i][2 * q + s][2 * r + 1];
        }
        const size_t o_t = ((size_t)t * B + b) * lanes + (size_t)d * H + unit;
        const size_t o_p =
            ((size_t)(tp < 0 ? 0 : tp) * B + b) * lanes + (size_t)d * H + unit;
        if constexpr (kLstm) {
          load_pair(ev[0], cs + o_t, nv, vec2);
          load_pair(ev[1], cs + o_p, tp < 0 ? 0 : nv, vec2);
        } else {
          load_pair(ev[0], ys + o_p, tp < 0 ? 0 : nv, vec2);
          ev[1][0] = ev[1][1] = 0.f;
        }
        emit_pair_f32(Cell{}, gv, ev, hh, v);
        // unit + 1 < Hp: rows of the planes are padded to a multiple of 4
        float* out = planes +
                     (((size_t)d * T + t) * Cell::kPlanes * B + b) * Hp + unit;
#pragma unroll
        for (int p = 0; p < Cell::kPlanes; ++p) {
          if (vec2) {
            *reinterpret_cast<float2*>(out + p * ps) = make_float2(v[p][0], v[p][1]);
          } else {
            out[p * ps] = v[p][0];
            out[p * ps + 1] = v[p][1];
          }
        }
      }
    }
  }
}

// Raise the dynamic shared memory limit of the cell's kernel once per
// device, at its first launch there (eager, before any capture).
template <class Cell>
cudaError_t prepass_tf32_ready() {
  static std::mutex mu;
  static std::map<int, bool> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(prepass_tf32_kernel<Cell>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TfTile<Cell>::kSmem);
  done[device] = err == cudaSuccess;
  return err;
}

// Launch the pre-pass of one cell on the stream.  w: with bf16 streams
// w_hh^T (ndir, G H, H) bf16, else w_hh (ndir, H, G H) fp32, rounded to the
// stream type; cs is unused by the GRU.
template <class Cell>
cudaError_t launch_prepass(const void* gx, const void* w, const void* ys,
                           const void* cs, void* planes, int T, int B, int H,
                           int Hp, int ndir, int bf16, cudaStream_t stream) {
  auto aligned = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (bf16) {
    const dim3 grid((T * B + kPreRows - 1) / kPreRows,
                    (H + kPreUnits - 1) / kPreUnits, ndir);
    // 16-byte rows of ys and w^T, 4-byte pairs of gx, cs and ys, where every
    // row start is so aligned
    const int vec8 = H % 8 == 0 && aligned(ys, 16) && aligned(w, 16);
    const int vec2 = H % 2 == 0 && aligned(gx, 4) && aligned(ys, 4) &&
                     (cs == nullptr || aligned(cs, 4));
    prepass_mma_kernel<Cell><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(gx),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(ys),
        static_cast<const __nv_bfloat16*>(cs), static_cast<float*>(planes), T,
        B, H, Hp, ndir, vec8, vec2);
    return cudaGetLastError();
  }
  cudaError_t err = prepass_tf32_ready<Cell>();
  if (err != cudaSuccess) return err;
  // 16-byte chunks of ys rows and w_hh rows, 8-byte pairs of gx, cs, ys
  // and the planes, where every row start is so aligned
  const int vec4 = H % 4 == 0 && aligned(ys, 16) && aligned(w, 16);
  const int vec2 = H % 2 == 0 && aligned(gx, 8) && aligned(ys, 8) &&
                   aligned(planes, 8) && (cs == nullptr || aligned(cs, 8));
  using Tile = TfTile<Cell>;
  const dim3 grid((T * B + Tile::kRows - 1) / Tile::kRows,
                  (H + Tile::kUnits - 1) / Tile::kUnits, ndir);
  prepass_tf32_kernel<Cell><<<grid, Tile::kThreads, Tile::kSmem, stream>>>(
      static_cast<const float*>(gx), static_cast<const float*>(w),
      static_cast<const float*>(ys), static_cast<const float*>(cs),
      static_cast<float*>(planes), T, B, H, Hp, ndir, vec4, vec2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// serial chain, bf16 cluster branch
// ---------------------------------------------------------------------------

// The cluster's shape for H and kM x 16 batch rows: Uc units per CTA (a
// multiple of 4), CL CTAs, the contraction depth Kp (G Uc rounded up to 16)
// and the shared memory: the resident weights, the dpre slice and one
// receive buffer.
struct ClusterShape {
  int uc, cl, kp, nt;
  size_t smem;
};

inline ClusterShape cluster_shape(int gates, int H, int km) {
  ClusterShape s;
  s.uc = ((H + kMaxCluster - 1) / kMaxCluster + 3) / 4 * 4;
  s.cl = (H + s.uc - 1) / s.uc;
  s.kp = (gates * s.uc + 15) / 16 * 16;
  s.nt = (H + 7) / 8;
  const size_t ldk = s.kp + 8;
  s.smem = ((size_t)8 * s.nt + kSlice * km) * ldk * 2 +
           (size_t)s.cl * kSlice * km * s.uc * sizeof(float);
  return s;
}

// dpre of 4 units of one (row, quad) pair from the carry-free planes pl
// (plane-major, 4 units each), dy and dh; updates the cell's own carry.
__device__ __forceinline__ void cell_step(LstmCell, const float (*pl)[4],
                                          const float* dyv, const float* dh,
                                          float* carry, float (*dpre)[4],
                                          float*) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float dh_t = dyv[e] + dh[e];
    const float dct = carry[e] + dh_t * pl[0][e];
    dpre[0][e] = dct * pl[1][e];
    dpre[1][e] = dct * pl[2][e];
    dpre[2][e] = dct * pl[3][e];
    dpre[3][e] = dh_t * pl[4][e];
    carry[e] = dct * pl[5][e];  // dc
  }
}

// GRU: dpre = dh_t [P_r, P_z, P_n], dhh_n = dh_t P_hn (written to dhhn), the
// carry is dh_t Z, added to the next step's product.  dpre[2] is what enters
// the product: dhh_n, not dpre_n.
__device__ __forceinline__ void cell_step(GruCell, const float (*pl)[4],
                                          const float* dyv, const float* dh,
                                          float* carry, float (*dpre)[4],
                                          float* dpre_n) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float dh_t = dyv[e] + (dh[e] + carry[e]);
    dpre[0][e] = dh_t * pl[0][e];
    dpre[1][e] = dh_t * pl[1][e];
    dpre_n[e] = dh_t * pl[2][e];
    dpre[2][e] = dh_t * pl[3][e];
    carry[e] = dh_t * pl[4][e];
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// Arrive without ordering memory; the operand makes the arrive wait for the
// shared-memory loads that produced it, so the caller's reads are done.
__device__ __forceinline__ void cluster_arrive_after(float v) {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::"f"(v)
               : "memory");
}

// Four floats into the shared memory of CTA `rank` of the cluster, at the
// address that p has in this CTA's.
__device__ __forceinline__ void st_cluster4(float* p, int rank, float4 v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// 4 floats as 4 packed bf16
__device__ __forceinline__ uint2 pack4_bf16(const float* v) {
  return make_uint2(bf16_bits(v[0]) | (unsigned)bf16_bits(v[1]) << 16,
                    bf16_bits(v[2]) | (unsigned)bf16_bits(v[3]) << 16);
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the first n of 4 packed bf16 at p: one 8-byte store when vec
__device__ __forceinline__ void store4_bf16(__nv_bfloat16* p, uint2 w, int n,
                                            bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<uint2*>(p) = w;
    return;
  }
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
  const unsigned short h[4] = {(unsigned short)(w.x & 0xffff),
                               (unsigned short)(w.x >> 16),
                               (unsigned short)(w.y & 0xffff),
                               (unsigned short)(w.y >> 16)};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) q[e] = h[e];
}

// Phase stamps of the serial step, for tools/probe_bwd_steps.py: built with
// BWD_STEP_STAMPS defined, thread 0 of the first CTA adds the clock64()
// cycles since the stamp before to bwd_step_cycles[i] at stamp i.  The
// package's build leaves them out.
#ifdef BWD_STEP_STAMPS
__device__ long long bwd_step_cycles[16];
#define BWD_STAMP_START                                                   \
  const bool stamp_ = threadIdx.x == 0 && blockIdx.x == 0 &&             \
                      blockIdx.y == 0 && blockIdx.z == 0;                 \
  long long last_ = clock64();
#define BWD_STAMP(i)                                                      \
  if (stamp_) {                                                           \
    const long long now_ = clock64();                                     \
    bwd_step_cycles[i] += now_ - last_;                                   \
    last_ = now_;                                                         \
  }
#else
#define BWD_STAMP_START
#define BWD_STAMP(i)
#endif

// Cluster (direction blockIdx.z, rows [16 kM blockIdx.y, +16 kM)), CTA rank
// blockIdx.x; see the header.  w is w_hh (ndir, H, G H) fp32 with bf16
// values; dy, dgx (and the GRU's dhhn) bf16.  vec4: dy, dgx and dhhn rows
// are 8-byte aligned at every 4th unit (H % 4 == 0).
//
// Per step, with one receive buffer: wait for the data of the step before,
// sum it into dh, arrive at "read" (the buffer may be refilled once every
// CTA has), form dpre, load the next step's planes, multiply, wait at
// "read", write the peers' shares, arrive with the data, and only then store
// dgx (global stores before a release arrive would hold it up).  The
// cluster's one hardware barrier alternates between the two.
template <class Cell, int kM>
__global__ void __launch_bounds__(kClusterThreads, 1)
    bwd_cluster_kernel(const float* __restrict__ planes,
                       const float* __restrict__ w,
                       const __nv_bfloat16* __restrict__ dy,
                       __nv_bfloat16* __restrict__ dgx,
                       __nv_bfloat16* __restrict__ dhhn, int T, int B, int H,
                       int Hp, int ndir, int uc, int kp, int vec4) {
  constexpr int G = Cell::kGates;
  constexpr int P = Cell::kPlanes;
  constexpr bool kGru = P == GruCell::kPlanes;
  constexpr int kRowsC = kSlice * kM;  // batch rows of the cluster
  extern __shared__ float4 hoist_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int d = blockIdx.z, r0 = blockIdx.y * kRowsC;
  const int nt = (H + 7) / 8;
  const int ldk = kp + 8;
  const int own0 = rank * uc;
  const size_t gh = (size_t)G * H;
  unsigned short* ws = reinterpret_cast<unsigned short*>(hoist_smem);
  unsigned short* as = ws + (size_t)8 * nt * ldk;               // [kRowsC][ldk]
  float* recv = reinterpret_cast<float*>(as + kRowsC * ldk);  // [cl][kRowsC][uc]

  // resident: the rows of w_hh that this CTA's gate columns meet
#pragma unroll 4
  for (int idx = tid; idx < 8 * nt * kp; idx += kClusterThreads) {
    const int n = idx / kp, k = idx % kp;
    const int q = k / uc, unit = own0 + k % uc;
    float v = 0.f;
    if (n < H && q < G && unit < H)
      v = w[((size_t)d * H + n) * gh + (size_t)q * H + unit];
    ws[(size_t)n * ldk + k] = bf16_bits(v);
  }
  for (int idx = tid; idx < kRowsC * ldk; idx += kClusterThreads) as[idx] = 0;

  // element-wise work: (row, 4-unit quad) pairs, kM per thread
  const int nq = uc / 4;
  const size_t ps = (size_t)B * Hp;
  const size_t lanes = (size_t)ndir * H;
  int row[kM], b[kM], u[kM];
  bool active[kM], live[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    const int pi = tid + j * kClusterThreads;
    active[j] = pi < kRowsC * nq;
    row[j] = active[j] ? pi / nq : 0;
    u[j] = own0 + 4 * (active[j] ? pi % nq : 0);
    b[j] = r0 + row[j];
    live[j] = active[j] && b[j] < B && u[j] < Hp;
  }

  float nx_pl[kM][P][4], nx_dy[kM][4];
  auto fetch = [&](int t) {
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      if (!live[j]) continue;
      const float* src =
          planes + (((size_t)d * T + t) * P * B + b[j]) * Hp + u[j];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(src + p * ps);
        nx_pl[j][p][0] = v.x, nx_pl[j][p][1] = v.y, nx_pl[j][p][2] = v.z,
        nx_pl[j][p][3] = v.w;
      }
      const __nv_bfloat16* dsrc =
          dy + ((size_t)t * B + b[j]) * lanes + d * H + u[j];
      if (vec4 && u[j] + 4 <= H) {
        const uint2 v = *reinterpret_cast<const uint2*>(dsrc);
        nx_dy[j][0] = lo_f(v.x), nx_dy[j][1] = hi_f(v.x);
        nx_dy[j][2] = lo_f(v.y), nx_dy[j][3] = hi_f(v.y);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          nx_dy[j][e] = u[j] + e < H ? __bfloat162float(dsrc[e]) : 0.f;
      }
    }
  };

  float carry[kM][4];
#pragma unroll
  for (int j = 0; j < kM; ++j) carry[j][0] = carry[j][1] = carry[j][2] = carry[j][3] = 0.f;
  fetch(d == 0 ? T - 1 : 0);
  cluster.sync();  // every CTA of the cluster runs and holds its weights
  BWD_STAMP_START

  for (int s = 0; s < T; ++s) {
    const int t = d == 0 ? T - 1 - s : s;
    const bool more = s + 1 < T;
    float dh[kM][4];
#pragma unroll
    for (int j = 0; j < kM; ++j) dh[j][0] = dh[j][1] = dh[j][2] = dh[j][3] = 0.f;
    if (s > 0) {
      cluster_wait();  // the partials of step s - 1 are in recv
      BWD_STAMP(0)  // wait for the data
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        if (!active[j]) continue;
        const float* src = recv + row[j] * uc + (u[j] - own0);
#pragma unroll
        for (int p = 0; p < kMaxCluster; ++p) {
          if (p < cl) {
            const float4 v =
                *reinterpret_cast<const float4*>(src + p * kRowsC * uc);
            dh[j][0] += v.x, dh[j][1] += v.y, dh[j][2] += v.z, dh[j][3] += v.w;
          }
        }
      }
    }
    BWD_STAMP(1)  // the receive sum
    // "read": recv may be refilled
    if (more) cluster_arrive_after(dh[0][0] + dh[kM - 1][3]);
    BWD_STAMP(2)  // the read arrive

    uint2 out[kM][G + kGru];  // dgx (and dhhn), stored after the exchange
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      if (!active[j]) continue;
      float dpre[G][4], dpre_n[4];
      cell_step(Cell{}, nx_pl[j], nx_dy[j], dh[j], carry[j], dpre, dpre_n);
      const int n = b[j] < B ? min(4, H - u[j]) : 0;  // units to store
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const uint2 w = pack4_bf16(dpre[q]);
        *reinterpret_cast<uint2*>(as + row[j] * ldk + q * uc + (u[j] - own0)) =
            n >= 4 ? w
                   : make_uint2((n > 0 ? w.x & 0xffff : 0) | (n > 1 ? w.x & 0xffff0000u : 0),
                                (n > 2 ? w.y & 0xffff : 0) | (n > 3 ? w.y & 0xffff0000u : 0));
        out[j][q] = kGru && q == 2 ? pack4_bf16(dpre_n) : w;
      }
      if constexpr (kGru) out[j][G] = pack4_bf16(dpre[2]);
    }
    BWD_STAMP(3)  // the element-wise step
    auto store_out = [&]() {
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        if (!active[j]) continue;
        const int n = b[j] < B ? min(4, H - u[j]) : 0;
        __nv_bfloat16* o = dgx + ((size_t)t * B + b[j]) * ndir * gh + d * gh + u[j];
#pragma unroll
        for (int q = 0; q < G; ++q) store4_bf16(o + (size_t)q * H, out[j][q], n, vec4);
        if constexpr (kGru)
          store4_bf16(dhhn + ((size_t)t * B + b[j]) * lanes + d * H + u[j],
                      out[j][G], n, vec4);
      }
    };
    if (!more) {
      store_out();
      break;
    }
    fetch(d == 0 ? t - 1 : t + 1);
    BWD_STAMP(4)  // the next step's loads issued
    __syncthreads();  // the CTA's dpre slice is in as
    BWD_STAMP(5)  // the CTA's barrier

    // partial dh of every unit from this CTA's gate columns: warp w owns
    // n-tiles [w ntw, w ntw + ntw) of every m-tile
    const int ntw = (nt + 7) / 8;
    const int j0 = warp * ntw;
    const int cnt = min(ntw, nt - j0);
    float acc[kM][kMaxNtw][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int i = 0; i < kMaxNtw; ++i)
        acc[mi][i][0] = acc[mi][i][1] = acc[mi][i][2] = acc[mi][i][3] = 0.f;
    if (cnt > 0) {
      for (int ks = 0; ks < kp / 16; ++ks) {
        unsigned a[kM][4], bf[kMaxNtw / 2][4];
#pragma unroll
        for (int mi = 0; mi < kM; ++mi)
          ldsm_a(a[mi], as + 16 * mi * ldk, ldk, 16 * ks, lane);
#pragma unroll
        for (int ip = 0; ip < kMaxNtw / 2; ++ip)
          if (2 * ip < cnt)
            ldsm_b2(bf[ip], ws, ldk, 8 * (j0 + 2 * ip), 16 * ks, lane);
#pragma unroll
        for (int i = 0; i < kMaxNtw; ++i)
          if (i < cnt)
#pragma unroll
            for (int mi = 0; mi < kM; ++mi)
              mma_bf16(acc[mi][i], a[mi], bf[i / 2][2 * (i & 1)],
                       bf[i / 2][2 * (i & 1) + 1]);
      }
    }
    BWD_STAMP(6)  // the product
    cluster_wait();  // every CTA has read recv
    BWD_STAMP(7)  // wait for the reads
    // each peer's share into its shared memory, this CTA's slot: lanes c and
    // c ^ 1 trade halves so that each writes 4 adjacent units of one row
    float* slot = recv + rank * kRowsC * uc;
    const bool odd = c & 1;
#pragma unroll
    for (int i = 0; i < kMaxNtw; ++i) {
      if (i < cnt) {
        const int n0 = 8 * (j0 + i) + 4 * (c >> 1);  // 4 units of the pair
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          const float* v = acc[mi][i];
          const float x0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
          const float x1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
          if (n0 < H) {
            const int peer = n0 / uc, off = n0 % uc;
            const int r = 16 * mi + g + (odd ? 8 : 0);
            st_cluster4(slot + r * uc + off, peer,
                        odd ? make_float4(x0, x1, v[2], v[3])
                            : make_float4(v[0], v[1], x0, x1));
          }
        }
      }
    }
    BWD_STAMP(8)  // the DSMEM stores
    cluster_arrive();  // the data of step s
    BWD_STAMP(9)  // the data arrive
    store_out();
    BWD_STAMP(10)  // the global stores
  }
}

constexpr int kMaxSmem = 232448;  // an H100 CTA's shared memory, opt-in

// The launch of a cluster kernel with cl CTAs a cluster over (slices, ndir);
// attr holds its cluster dimension.
inline cudaLaunchConfig_t cluster_config(int cl, int slices, int ndir,
                                         int threads, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, slices, ndir);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Whether all `slices` x ndir clusters of `kernel` fit on the current device
// at once; raises the kernel's dynamic shared memory limit to the card's
// maximum (and allows 16-CTA clusters), so that no launch needs the
// attribute calls.
inline cudaError_t clusters_fit(const void* kernel, int cl, int slices,
                                int ndir, int threads, size_t smem,
                                bool* fit) {
  *fit = false;
  if (smem > (size_t)kMaxSmem) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  if (cl > kMaxCluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(cl, slices, ndir, threads, smem, 0, attr);
  int capacity = 0;
  err = cudaOccupancyMaxActiveClusters(&capacity, kernel, &cfg);
  if (err != cudaSuccess) return err;
  *fit = capacity >= slices * ndir;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// serial chain, fp32 cluster branch (the LSTM on fp32 streams)
// ---------------------------------------------------------------------------

constexpr int kFmaBwdRows = 16;  // batch rows of an fp32 cluster
constexpr int kFmaBwdLd = kFmaBwdRows + 4;  // row stride of dpre^T, floats
constexpr int kFmaBwdThreads = 384;  // most threads a CTA

// The shape of the fp32 cluster for G gates and H: Uc units a CTA (a
// multiple of 4), CL CTAs (8 where the shared memory fits, else 16), Kp
// gate columns a CTA (G Uc rounded up to 16; the GRU's padding is zero),
// KSN k slices of each output quad (the most, up to 8, that
// kFmaBwdThreads threads hold), the threads and the shared memory: the
// resident rows [Kp][4 nq] (nq = the output quads, ceil(H / 4)), dpre^T
// [Kp][kFmaBwdLd] and the receive buffer [CL][16][Uc].  ok: the shared
// memory fits, the 16 x Uc / 4 element-wise (row, quad) pairs have a
// thread each and KSN >= 2.
struct FmaBwdShape {
  int uc, cl, kp, ksn, threads;
  size_t smem;
  bool ok;
};

inline FmaBwdShape fma_bwd_shape(int gates, int H) {
  FmaBwdShape s{0, 0, 0, 0, 0, 0, false};
  const int nq = (H + 3) / 4;
  for (int cl : {kMaxCluster, kMaxClusterNP}) {
    s.uc = ((H + cl - 1) / cl + 3) / 4 * 4;
    s.cl = (H + s.uc - 1) / s.uc;
    s.kp = (gates * s.uc + 15) / 16 * 16;
    s.smem = ((size_t)s.kp * 4 * nq + (size_t)s.kp * kFmaBwdLd +
              (size_t)s.cl * kFmaBwdRows * s.uc) * sizeof(float);
    if (s.smem <= (size_t)kMaxSmem) break;
  }
  s.ksn = 8;
  while (s.ksn > 1 && nq * s.ksn > kFmaBwdThreads) s.ksn /= 2;
  s.threads = (nq * s.ksn + 31) / 32 * 32;
  s.ok = s.smem <= (size_t)kMaxSmem && s.ksn >= 2 &&
         kFmaBwdRows * (s.uc / 4) <= s.threads;
  return s;
}

// One round of the reduce-scatter of bwd_fma_kernel over the k slices of an
// output quad: the pair of entries (2i, 2i + 1) of acc differs in bit kR of
// its row; the lane with bit kR of its slice ks set keeps the odd one and
// adds the partner's (lanes delta << kR apart), into entry i.  Pairs of
// rows past `live` (a multiple of 4) are skipped.
template <int kR, int kRows>
__device__ __forceinline__ void reduce_round(float (&acc)[kRows][4], int ks,
                                             int delta, int live) {
  const bool upper = (ks >> kR) & 1;
#pragma unroll
  for (int i = 0; i < (kRows >> (kR + 1)); ++i) {
    if (((2 * i) << kR) < live) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float send = upper ? acc[2 * i][e] : acc[2 * i + 1][e];
        const float keep = upper ? acc[2 * i + 1][e] : acc[2 * i][e];
        acc[i][e] = keep + __shfl_xor_sync(0xffffffffu, send, delta << kR);
      }
    }
  }
}

// Cluster (direction blockIdx.z, rows [16 blockIdx.y, +16)), CTA rank
// blockIdx.x, of the serial chain on fp32 streams; see the header.  planes
// (ndir, T, P, B, Hp), w = w_hh (ndir, H, G H), dy (T, B, ndir H), dgx (T,
// B, ndir G H) and the GRU's dhhn (T, B, ndir H; null for the LSTM), all
// fp32.  kp: the CTA's gate columns, G Uc rounded up to 16.  vec4: w, dy,
// dgx and dhhn rows are 16-byte aligned at every 4th unit (H % 4 == 0).  A
// thread's sums hold kG 4-row groups: 2 where no slice has more than 8 rows
// (B <= 8), else 4.
template <class Cell, int KSN, int kG>
__global__ void __launch_bounds__(kFmaBwdThreads, 1)
    bwd_fma_kernel(const float* __restrict__ planes,
                   const float* __restrict__ w, const float* __restrict__ dy,
                   float* __restrict__ dgx, float* __restrict__ dhhn, int T,
                   int B, int H, int Hp, int ndir, int uc, int kp, int vec4) {
  constexpr int P = Cell::kPlanes;
  constexpr int G = Cell::kGates;
  constexpr bool kGru = std::is_same<Cell, GruCell>::value;
  constexpr int R = kFmaBwdRows;
  constexpr int kR = 4 * kG;      // rows a thread's sums hold
  constexpr int kPer = 32 / KSN;  // output quads a warp
  constexpr int M = kR / KSN;     // rows a lane holds after the reduce-scatter
  static_assert(KSN <= kR, "a row a lane at least");
  extern __shared__ float4 hoist_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, nthreads = blockDim.x;
  const int d = blockIdx.z, r0 = blockIdx.y * R;
  const int own0 = rank * uc;
  const int nq = (H + 3) / 4;  // output quads
  const int K = kp;  // this CTA's gate columns: k = q Uc + u, zero past G Uc
  const size_t gh = (size_t)G * H;
  float4* ws = hoist_smem;                                    // [K][nq]
  float* dT = reinterpret_cast<float*>(ws + (size_t)K * nq);  // [K][kFmaBwdLd]
  float* recv = dT + (size_t)K * kFmaBwdLd;                   // [cl][R][uc]

  // resident: ws[k][n] = w_hh[d][n][q H + own0 + u], zero past H in both
  // and past G Uc in k.  Thread (k quad, n), n fastest: one float4 of four
  // gate columns read, four conflict-free shared stores; kLoadDepth / 4
  // entries in flight.
  {
    float* wf = reinterpret_cast<float*>(ws);
    const int ldw = 4 * nq, n_items = K / 4 * ldw;
    const float* wd = w + (size_t)d * H * gh;
    constexpr int kEntries = kLoadDepth / 4;
    for (int i0 = tid; i0 < n_items; i0 += kEntries * nthreads) {
      float4 v[kEntries];
#pragma unroll
      for (int i = 0; i < kEntries; ++i) {
        const int idx = i0 + i * nthreads;
        const int n = idx % ldw, k = 4 * (idx / ldw);
        const int unit = own0 + k % uc;  // k .. k + 3: one gate, 4 units
        const int nu =
            idx < n_items && n < H && k / uc < G ? min(4, H - unit) : 0;
        const float* src = wd + (size_t)(nu > 0 ? n : 0) * gh +
                           (size_t)(k / uc) * H + (nu > 0 ? unit : 0);
        if (vec4 && nu >= 4) {
          v[i] = *reinterpret_cast<const float4*>(src);
        } else {
          v[i] = make_float4(nu > 0 ? src[0] : 0.f, nu > 1 ? src[1] : 0.f,
                             nu > 2 ? src[2] : 0.f, nu > 3 ? src[3] : 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < kEntries; ++i) {
        const int idx = i0 + i * nthreads;
        if (idx < n_items) {
          float* dst = wf + (size_t)4 * (idx / ldw) * ldw + idx % ldw;
          dst[0] = v[i].x, dst[ldw] = v[i].y, dst[2 * ldw] = v[i].z,
          dst[3 * ldw] = v[i].w;
        }
      }
    }
  }
  for (int idx = tid; idx < K * kFmaBwdLd; idx += nthreads) dT[idx] = 0.f;
  for (int idx = tid; idx < cl * R * uc; idx += nthreads) recv[idx] = 0.f;

  // element-wise work: thread (row, 4-unit quad of the CTA's units)
  const int nqc = uc / 4;
  const int row = tid / nqc, u = own0 + 4 * (tid % nqc), b = r0 + row;
  const bool live = tid < R * nqc && b < B && u < H;
  const int nu = live ? min(4, H - u) : 0;  // units to store
  const size_t ps = (size_t)B * Hp;
  const size_t lanes = (size_t)ndir * H;
  float nx_pl[P][4], nx_dy[4];
  auto fetch = [&](int t) {
    if (!live) return;
    const float* src = planes + (((size_t)d * T + t) * P * B + b) * Hp + u;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(src + p * ps);
      nx_pl[p][0] = v.x, nx_pl[p][1] = v.y, nx_pl[p][2] = v.z, nx_pl[p][3] = v.w;
    }
    const float* dsrc = dy + ((size_t)t * B + b) * lanes + (size_t)d * H + u;
    if (vec4 && nu >= 4) {
      const float4 v = *reinterpret_cast<const float4*>(dsrc);
      nx_dy[0] = v.x, nx_dy[1] = v.y, nx_dy[2] = v.z, nx_dy[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) nx_dy[e] = e < nu ? dsrc[e] : 0.f;
    }
  };

  // the product's thread: output quad `item`, k slice ks; the rows of the
  // slice in 4-row groups, rgs of them live
  const int item = (tid >> 5) * kPer + lane % kPer, ks = lane / kPer;
  const bool active = item < nq;
  const int rows = min(R, B - r0), rgs = (rows + 3) / 4;
  const int n0 = 4 * min(item, nq - 1);  // the quad's first unit
  const int peer = n0 / uc, off = n0 % uc;
  const float4* wq = ws + min(item, nq - 1);
  const float4* d4 = reinterpret_cast<const float4*>(dT);

  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  fetch(d == 0 ? T - 1 : 0);
  cluster.sync();  // every CTA of the cluster runs and holds its weights
  BWD_STAMP_START

  for (int s = 0; s < T; ++s) {
    const int t = d == 0 ? T - 1 - s : s;
    const bool more = s + 1 < T;
    float dh[4] = {0.f, 0.f, 0.f, 0.f};
    if (s > 0) {
      cluster_wait();  // the partials of step s - 1 are in recv
      BWD_STAMP(0)  // wait for the data
      if (live) {
        const float* src = recv + row * uc + (u - own0);
        for (int p = 0; p < cl; ++p) {  // in rank order
          const float4 v = *reinterpret_cast<const float4*>(src + p * R * uc);
          dh[0] += v.x, dh[1] += v.y, dh[2] += v.z, dh[3] += v.w;
        }
      }
    }
    BWD_STAMP(1)  // the receive sum
    // "read": recv may be refilled
    if (more) cluster_arrive_after(dh[0] + dh[1] + dh[2] + dh[3]);
    BWD_STAMP(2)  // the read arrive

    if (live) {
      // dpre[q] enters the product (the GRU's dpre[2] is dhh_n), and dgx
      // gets dpre_n in its place
      float dpre[G][4], dpre_n[4];
      cell_step(Cell{}, nx_pl, nx_dy, dh, carry, dpre, dpre_n);
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dT[(q * uc + u - own0 + e) * kFmaBwdLd + row] = e < nu ? dpre[q][e] : 0.f;
      // dgx (and dhhn), stored before the product (the stores have long
      // drained by the release arrive), so that dpre holds no registers
      // through it
      auto store4 = [&](float* oq, const float* v) {
        if (vec4 && nu >= 4) {
          *reinterpret_cast<float4*>(oq) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < nu) oq[e] = v[e];
        }
      };
      float* o = dgx + ((size_t)t * B + b) * ndir * gh + d * gh + u;
#pragma unroll
      for (int q = 0; q < G; ++q)
        store4(o + (size_t)q * H, kGru && q == 2 ? dpre_n : dpre[q]);
      if constexpr (kGru)
        store4(dhhn + ((size_t)t * B + b) * lanes + (size_t)d * H + u, dpre[2]);
    }
    BWD_STAMP(3)  // the element-wise step and dgx issued
    if (!more) break;
    fetch(d == 0 ? t - 1 : t + 1);
    BWD_STAMP(4)  // the next step's loads issued
    __syncthreads();  // the CTA's dpre slice is in dT
    BWD_STAMP(5)  // the CTA's barrier

    // partial dh of the quad's four units for every row from this CTA's
    // gate columns k = ks, ks + KSN, ...: acc[row][unit]
    float acc[kR][4];
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (active) {
      // K is a multiple of 16: two k a slice at a time, loads first
      for (int k = ks; k < K; k += 2 * KSN) {
        const float4 w2[2] = {wq[(size_t)k * nq], wq[(size_t)(k + KSN) * nq]};
        float4 h2[2][kG];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int g = 0; g < kG; ++g)
            h2[x][g] = g < rgs ? d4[(k + x * KSN) * (kFmaBwdLd / 4) + g]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < rgs) {
              const float hr[4] = {h2[x][g].x, h2[x][g].y, h2[x][g].z,
                                   h2[x][g].w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float* a = acc[4 * g + j];
                a[0] = fmaf(hr[j], w2[x].x, a[0]);
                a[1] = fmaf(hr[j], w2[x].y, a[1]);
                a[2] = fmaf(hr[j], w2[x].z, a[2]);
                a[3] = fmaf(hr[j], w2[x].w, a[3]);
              }
            }
          }
      }
    }
    // reduce-scatter over the KSN slices of the quad (reduce_round): entry
    // i then holds row i KSN + ks
    reduce_round<0>(acc, ks, kPer, 4 * rgs);
    if constexpr (KSN >= 4) reduce_round<1>(acc, ks, kPer, 4 * rgs);
    if constexpr (KSN >= 8) reduce_round<2>(acc, ks, kPer, 4 * rgs);
    BWD_STAMP(6)  // the product and the reduce-scatter
    cluster_wait();  // every CTA has read recv
    BWD_STAMP(7)  // wait for the reads
    // the quad's rows into the peer that owns it, this CTA's slot
    if (active && n0 < H) {
      float* slot = recv + (size_t)rank * R * uc + off;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const int j = i * KSN + ks;
        if (j < rows)
          st_cluster4(slot + j * uc, peer,
                      make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
    BWD_STAMP(8)  // the DSMEM stores
    cluster_arrive();  // the data of step s
    BWD_STAMP(9)  // the data arrive
  }
}

// bwd_fma_kernel with ksn k slices (fma_bwd_shape) for B rows
template <class Cell, int kG>
const void* fma_bwd_kernel_g(int ksn) {
  switch (ksn) {
    case 2: return reinterpret_cast<const void*>(bwd_fma_kernel<Cell, 2, kG>);
    case 4: return reinterpret_cast<const void*>(bwd_fma_kernel<Cell, 4, kG>);
    default: return reinterpret_cast<const void*>(bwd_fma_kernel<Cell, 8, kG>);
  }
}
template <class Cell>
const void* fma_bwd_kernel_for(int ksn, int B) {
  return B <= 8 ? fma_bwd_kernel_g<Cell, 2>(ksn)
                : fma_bwd_kernel_g<Cell, 4>(ksn);
}

// Launch the fp32 cluster branch (cluster_branch chose it for the shape).
// dhhn: the GRU's, null for the LSTM.
template <class Cell>
cudaError_t launch_bwd_fma(const void* planes, const void* w, const void* dy,
                           void* dgx, void* dhhn, int T, int B, int H, int Hp,
                           int ndir, cudaStream_t stream) {
  const FmaBwdShape f = fma_bwd_shape(Cell::kGates, H);
  if (!f.ok) return cudaErrorInvalidValue;
  auto aligned16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  int vec4 = H % 4 == 0 && aligned16(w) && aligned16(dy) && aligned16(dgx) &&
             (dhhn == nullptr || aligned16(dhhn));
  int uc = f.uc, kp = f.kp;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(f.cl, (B + kFmaBwdRows - 1) / kFmaBwdRows, ndir,
                     f.threads, f.smem, stream, attr);
  void* args[] = {&planes, &w,   &dy,  &dgx, &dhhn, &T,  &B,
                  &H,      &Hp,  &ndir, &uc, &kp,   &vec4};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, fma_bwd_kernel_for<Cell>(f.ksn, B), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The clusters of bwd_cluster_kernel<Cell, kM> that the current device
// holds at once at this shape, 0 where its shared memory does not fit.
// Raises the kernel's dynamic shared memory limit to the card's maximum,
// so that no launch needs the attribute call.
template <class Cell, int kM>
cudaError_t cluster_capacity(const ClusterShape& cs, int B, int ndir,
                             int* capacity) {
  *capacity = 0;
  if (cs.smem > kMaxSmem) return cudaSuccess;
  auto kernel = bwd_cluster_kernel<Cell, kM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      cs.cl, (B + kSlice * kM - 1) / (kSlice * kM), ndir, kClusterThreads,
      cs.smem, 0, attr);
  return cudaOccupancyMaxActiveClusters(
      capacity, reinterpret_cast<const void*>(kernel), &cfg);
}

}  // namespace

#include "bwd_wide.cuh"  // the wide-batch fp32 branch, over the cells above

namespace {

// the serial chain's branches, as the entry points report them
enum BwdBranch {
  kBwdGrid = 0,
  kBwdMma16 = 1,
  kBwdMma32 = 2,
  kBwdFma16 = 3,
  kBwdWide = 4
};

// Built with -DPARENT_BRANCHES (tools/parent_forms.py; the package's build
// never defines it) the launchers keep the grid where the wide forward
// (fwd_wide.cuh), the GRU's fp32 cluster and the wide backward
// (bwd_wide.cuh) took it over, so that one run on the card times both
// forms.
#ifdef PARENT_BRANCHES
constexpr bool kParentBranches = true;
#else
constexpr bool kParentBranches = false;
#endif

// The serial chain's branch for the shape on the current device
// (BwdBranch).  bf16 streams take bwd_cluster_kernel where its shared
// memory fits and a cluster can be placed: 32 rows where the 16-row
// clusters would not all fit on the card at once and the 32-row ones do.
// fp32 streams take bwd_fma_kernel where its shared memory fits and all of
// its 16-row clusters fit at once, else bwd_wide_kernel where its shape
// holds and all its CTAs are resident at once.  Every other shape the
// grid.  Asked of the runtime once per (device, B, H, ndir, stream type)
// and kept: every training step asks again.
template <class Cell>
cudaError_t cluster_branch(int B, int H, int ndir, int bf16, int* branch) {
  *branch = kBwdGrid;
  if (kParentBranches && !bf16 && std::is_same<Cell, GruCell>::value)
    return cudaSuccess;
  const ClusterShape cs1 = cluster_shape(Cell::kGates, H, 1);
  if (bf16 && (cs1.uc > 64 || (cs1.nt + 7) / 8 > kMaxNtw)) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::array<int, 5>, int> known;
  const std::array<int, 5> key = {device, B, H, ndir, bf16};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *branch = hit->second;
    return cudaSuccess;
  }
  int taken = kBwdGrid;
  if (!bf16) {
    const FmaBwdShape f = fma_bwd_shape(Cell::kGates, H);
    bool fit = false;
    if (f.ok) {
      err = clusters_fit(fma_bwd_kernel_for<Cell>(f.ksn, B), f.cl,
                         (B + kFmaBwdRows - 1) / kFmaBwdRows, ndir, f.threads,
                         f.smem, &fit);
      if (err != cudaSuccess) return err;
    }
    if (fit) {
      taken = kBwdFma16;
    } else if (!kParentBranches) {
      err = bwd_wide_fits<Cell>(B, H, ndir, &fit);
      if (err != cudaSuccess) return err;
      if (fit) taken = kBwdWide;
    }
  } else {
    int cap1 = 0, cap2 = 0;
    err = cluster_capacity<Cell, 1>(cs1, B, ndir, &cap1);
    if (err != cudaSuccess) return err;
    taken = cap1 >= 1 ? kBwdMma16 : kBwdGrid;
    const int need1 = ndir * ((B + kSlice - 1) / kSlice);
    const int need2 = ndir * ((B + 2 * kSlice - 1) / (2 * kSlice));
    if (need1 > cap1 && need2 < need1) {
      err = cluster_capacity<Cell, 2>(cluster_shape(Cell::kGates, H, 2), B,
                                      ndir, &cap2);
      if (err != cudaSuccess) return err;
      if (cap2 >= 1 && (need2 <= cap2 || cap1 < 1)) taken = kBwdMma32;
    }
  }
  known[key] = taken;
  *branch = taken;
  return cudaSuccess;
}

// Launch the cluster branch with 16 kM batch rows a cluster (cluster_branch
// chose it for the shape).
template <class Cell, int kM>
cudaError_t launch_cluster(const void* planes, const void* w, const void* dy,
                           void* dgx, void* dhhn, int T, int B, int H, int Hp,
                           int ndir, cudaStream_t stream) {
  const ClusterShape cs = cluster_shape(Cell::kGates, H, kM);
  // dy, dgx, dhhn in 8-byte pieces of 4 units where every row start is
  // so aligned
  auto aligned8 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 8 == 0;
  };
  const int vec4 = H % 4 == 0 && aligned8(dy) && aligned8(dgx) &&
                   (dhhn == nullptr || aligned8(dhhn));
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      cs.cl, (B + kSlice * kM - 1) / (kSlice * kM), ndir, kClusterThreads,
      cs.smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bwd_cluster_kernel<Cell, kM>, static_cast<const float*>(planes),
      static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dgx), static_cast<__nv_bfloat16*>(dhhn), T,
      B, H, Hp, ndir, cs.uc, cs.kp, vec4);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
