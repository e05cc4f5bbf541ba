// The wide-batch branch of the recurrences for Hopper (sm_90a), in two
// forms of one kernel:
//   wide_fp32 (fp32 products): the LSTM eval forward at every stream dtype,
//     the LSTM training forward on fp32 streams (which also writes cs), the
//     GRU forward on fp32 streams, and the tanh cell's forward and backward
//     on fp32 streams, where the fp32 cluster kernels (fwd_fma_kernel,
//     fma1_kernel, fwd_cluster.cuh) cannot place all their clusters at
//     once: B >= 64 at H = 384 for the gated cells, where 8 or 16 clusters
//     of 16 one-CTA-per-SM blocks are more than the card holds, and B >=
//     113 for the tanh cell with two directions (16 or more clusters of 8),
//     and H past those clusters' resident bounds;
//   wide_bf16 (bf16 products, fwd_wide_kernel<Cell, __nv_bfloat16, true>):
//     the LSTM training forward and the GRU forward on bf16 streams where
//     neither bf16 cluster of fwd_mma_kernel holds the shape (LSTM H > 432,
//     GRU H > 496, or B too wide for their clusters): DeepSpeech2's H =
//     1024 at B = 64.  See "bf16 products" below.
// fwd_cluster.cuh includes this header after its cells (cell_fwd,
// step_time) and stamps; its launcher (fwd_branch) chooses the branch.
//
// Replaces, for those shapes (the grid kernels of lstm_fwd.cuh, gru_fwd.cuh,
// rnn_fwd.cuh and rnn_bidir_train.cu stay the branch past the bounds below):
//   ctc_pytorch_tpu/ops/lstm_pallas_v2.py:142 lstm_bidir_pallas_v2 (the
//     pallas_call at :177, cell _cell2);
//   ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py:438, the forward
//     pallas_call of lstm_scan_train_v2;
//   ctc_pytorch_tpu/ops/gru_pallas_v2.py:352, the forward pallas_call
//     shared by gru_bidir_v2 and gru_scan_train_v2;
//   ctc_pytorch_tpu/ops/rnn_pallas_v2.py:228 (_fwd_pallas, shared by
//     rnn_bidir_v2 and rnn_scan_v2) and :258 (_bwd_pallas, the backward of
//     rnn_scan_v2).
// The function is the grid kernels' and the twins' (fwd_cluster.cuh says
// where each rounds): the product sums h_{t-1} (fp32; rounded to S first
// where kRound) times fp32 w_hh, the gate math and the carries are fp32.
//
// The tanh backward (TanhBwdCell) runs on this kernel under the policy that
// fwd_mma_kernel and fma1_kernel carry (kBackward, kInPlanes, step_time):
// its step has the forward's shape exactly, dpre = (dy + dh) (1 - y^2)
// exchanged every step into dh = dpre @ w_hh^T, and nothing to hoist (the
// gated cells' backward needs the pre-pass planes of bwd_hoist.cuh and
// contracts over G H columns, hence bwd_wide.cuh).  So the resident columns
// are rows of w_hh, a step reads dy (in the place of gx) and the saved ys,
// stores dgx where the forward stores ys, exchanges dpre as h, and direction
// 0 walks time from T - 1 down.  A one-gate step at the bench shape is 16
// rows x 48 columns x 384 x 3 = 0.9 M MACs a CTA, a quarter of the LSTM's.
//
// What bounds it: at the bench shape (T = 80, B = 128, H = 384, two
// directions) a step is 151 M fp32 multiply-adds, 24.2 GFLOP a launch:
// 0.36 ms at 67 TFLOP/s of fp32 FMA.  The grid kernel takes 22 us a step,
// and its clock64 stamps (tools/probe_bwd_steps.py, PERF.md §5) put 68% of
// it in the product (30.3k of 44.3k cycles: 52 FMAs a clock of the SM's
// 128), 11% in staging h through shared memory, 6% in grid.sync().  So the
// product moves to the tensor cores and the grid barrier goes.  The tanh
// cell there: 6.04 GFLOP a launch, 0.090 ms of fp32 FMA (its three TF32
// passes 0.037 ms at 495 TFLOP/s), forward and backward alike:
//
// Product: 3xTF32 on mma.sync m16n8k8.  Each operand is split x = hi + lo,
// hi = x rounded to tf32 (to nearest, ties away from zero: the bits plus
// 0x1000, masked) and lo = x - hi (exact in fp32), which the tensor core
// reads as tf32 by its upper 19 bits (truncated, as CUTLASS's fast 3xTF32
// relies on); the sums take lo_h hi_w + hi_h lo_w + hi_h hi_w in fp32,
// which keeps the fp32 contract (1e-4 against the fp32 twin; a single TF32
// pass does not).  lo's truncation and the dropped lo_h lo_w are ~2^-21
// of a product.  The split is integer work (an add and a mask a value: the
// SM's integer pipe runs at half the fp32 rate), so lo is not rounded
// again (the product's stamps fell from 12.3k to 10.6k cycles a step);
// what is left runs at the mma.sync TF32 rate, ~12 cycles an m16n8k8 per
// SM sub-partition, three times over.  Work a step per CTA at the
// bench shape: 32 rows x 96 columns x 384 x 3 = 3.5 M MACs, ~3.5k
// tensor-core instructions, where fp32 FMA would take ~20k cycles.
//
// Layout: persistent, weights resident, one CTA an SM.  CTA (j, r, d) owns
// Uc units [j Uc, j Uc + Uc) of direction d (Uc a multiple of 8) with all G
// gate columns of them, and RB batch rows [r RB, r RB + RB): the columns
// stay in shared memory for the whole launch as fp32, in the order of the
// mma's B fragments (one 8-byte load a lane, conflict-free), split when
// loaded.  Rows never meet, so the chains of the RB-row blocks are
// independent; splitting the rows as well as the units cuts what each CTA
// reads of h a step to RB x H.  Warp (m-tile, unit block, k split kh) does
// G n-tiles (gate q of 8 units) of one 16-row m-tile over its share of the
// k-steps; the KS splits of a (m-tile, unit block) leave their sums in
// shared memory and meet at a named barrier, and each adds, in kh order,
// the sums of 4 / KS of the thread's four (row, unit) pairs (rows g, g + 8,
// units 2c, 2c + 1, all G gates) and does their gate math, so that no split
// waits on another's transcendentals and the carries (c, the GRU's h) stay
// in the registers of the thread that owns the pair.
//
// The exchange, with no grid barrier: h_t goes to a global double buffer in
// the mma's A-fragment order (per 16-row m-tile and 8-unit k-step, lane l
// holds its four elements as one float4), so a reader loads each k-step of
// its A operand with one 16-byte L2 load a lane, eight k-steps in flight,
// straight into registers: no shared-memory staging, no CTA barrier.  The
// KS writer warps of (m-tile, unit block) store their parts of its 16 x 8
// block, fence, and each adds one to that block's flag with a release
// reduction; a reader acquires the flags of its k-steps (one lane each, KS
// times the step) before it loads them.  Flags count the steps, so nothing
// is reset between steps; the launcher zeroes them with a memset on the
// launch's stream before each launch, which a CUDA graph replays.  Directions and row blocks never
// wait on each other.  A writer overwrites a block of the buffer two steps
// later only after every warp of its m-tile has published the step between,
// which each does after its last read.  The k-steps are summed in a fixed
// order whatever the order in which they arrive, so a graph replay equals
// the eager call bit for bit.  Spinning needs every CTA resident: the
// launch is cooperative (the runtime refuses a grid that cannot be
// co-resident, and the launcher asks the occupancy first), and a spin that
// outlasts kWideSpinLimit polls traps: a fault, never a hang.
// Against the usual Hopper form (TMA bulk copies of 64-unit k-tiles into a
// shared ring, multicast across a cluster): the stamps show staging at 11%
// and the product at 68%; with row blocks a CTA reads 49 KB of h a step (6.3
// MB over the card, not 25 MB), and the fragment-order buffer loads it into
// the registers that the mma reads with no staging at all, so neither TMA
// nor multicast is used.
//
// The one-gate cell stages h.  Each unit block of a CTA loads the whole A
// operand of its m-tile, so the card reads h from L2 once a unit block:
// 48 times a step at H = 384 (18.9 MB at the tanh bench shape, 147 KB a
// CTA).  The gated cells' G n-tiles a warp hide that under a G times longer
// product; the one-gate cell's product phase stayed at 8.1-8.5k cycles a
// step (tools/probe_bwd_steps.py) with its mma on one chain or on three.
// So where two steps of the CTA's RB rows of h fit in shared memory
// beside the weights (stage: 48 KB at the bench shape, 2 RB Hk x 4 bytes),
// the CTA's warps first copy its m-tiles' k-steps of h_{s-1}, each once
// (one flag wait and one 16-byte L2 load a lane a k-step), into a buffer
// of the step's parity, meet at one CTA barrier, and the warps read their
// A fragments from there: 24.6 KB a CTA a step, 3.1 MB over the card.
// Elsewhere (B = 128 at H past 552, B <= 16 past 1056) each warp loads its
// k-steps from L2 as the gated cells do.  A step's staging buffer is
// rewritten two steps later, after every warp of the CTA passed the
// barrier of the step between, which follows its last read of it.
//
// The shape (wide_shape): the Uc (a multiple of 8) and RB (a multiple of
// 16) whose CTAs, ndir x ceil(B / RB) x ceil(H / Uc), fit on the card's SMs
// with the least work a CTA (RB x Uc; ties to the larger Uc, which reads
// less h), weights and partial sums within 227 KB and at most 12 warps (168
// registers a thread); KS (1, 2 or 4) the fewest splits that give 8
// warps.  Bench shape: Uc =
// 24, RB = 32, KS = 2: 128 CTAs of 12 warps, 147 KB of weights + 48 KB of
// partials; B = 64: RB = 16, KS = 4, 128 CTAs; the GRU at (B = 128, H =
// 256): Uc = 32, RB = 16, KS = 2, 128 CTAs of 8 warps, 98 KB + 24 KB.
// Shared memory is E G Uc Hk bytes of weights (E = 4 for fp32 products, 2
// for bf16; Hk = H rounded up to 8) and,
// where KS > 1, 1024 G KS groups bytes of partials (groups = the CTA's
// m-tiles x unit blocks); a launch asks for at least 116 KB so that two
// CTAs never share an SM.  Bound (the largest H that has a shape), on a
// 132-SM H100 with two directions: LSTM H <= 776 at B <= 16, 904 at B = 64,
// 600 at B = 128; GRU H <= 1056 at B <= 64, 792 at B = 128; with one
// direction LSTM H <= 1056, GRU H <= 1080 at B <= 16.  The tanh cell at
// (B = 128, H = 384, two directions): Uc = 48, RB = 16, KS = 2, 128 CTAs of
// 12 warps, 74 KB of weights + 12 KB of partials + 48 KB of staged h; its
// bound (chosen without the staging, which is taken where it fits) with
// two directions H <= 1752 at B <= 16, 1584 at B = 64, 792 at B = 128, with
// one direction H <= 2288 at B <= 16.  Past it the grid.
//
// bf16 products (wide_bf16).  The LSTM training forward and the GRU on
// bf16 streams round w_hh (the caller does) and each h to bf16 before the
// product and sum in fp32 (fwd_cluster.cuh): one bf16 mma.sync m16n8k16
// with fp32 sums forms the same products (each exact in fp32) where fp32
// products need three TF32 passes a k-step of 8; the tensor core adds them
// in its own order and with its own rounding, not with fp32 adds rounded
// to nearest, so the sums differ from the twin's in their last bits.  So
// this form keeps the layout, the
// exchange protocol, the flags, the gate math and the stores of the fp32
// one, and changes three things:
//   the weights are resident as bf16 (converted on load from the caller's
//     fp32 copy, exactly), in the order of the m16n8k16 B fragments: per
//     (unit block, gate, k-step of 16) lane 4 g + c holds the packed pairs
//     (k = 2 c, 2 c + 1) and (2 c + 8, 2 c + 9) of column g, one 8-byte
//     load; where H / 8 is odd the last k-step holds its first half alone
//     (one 4-byte word a lane, the second B register zero), so that the
//     weights take 2 G Uc Hk bytes as the shape search counts them;
//   the exchange buffer holds h as bf16 in the A-fragment order of a
//     k-step of 16 (lane 4 g + c: rows g, g + 8 x units (2 c, 2 c + 1), then
//     (2 c + 8, 2 c + 9)), one 16-byte L2 load a lane a k-step: half the
//     bytes of the fp32 exchange, and exact, since h is rounded to bf16
//     before the product anyway.  The writer warp of 8-unit block j owns
//     lane l's words (2 (j % 2), 2 (j % 2) + 1) of k-step j / 2, one 8-byte
//     store a lane (KS = 1); the flags stay one an 8-unit block, and a
//     reader of k-step kb waits for blocks 2 kb and 2 kb + 1 (where H / 8
//     is odd the last k-step's second half has no writer: the reader zeroes
//     it, so an unwritten buffer never reaches the sums);
//   the product is one mma.sync a gate a k-step of 16, with eight k-steps
//     of h in flight a warp (kWideDepth) and each k-step's B fragments read
//     from shared memory one k-step ahead, before the next load of h (whose
//     memory clobber no shared load may cross; the depth and the read
//     ahead were tuned at DeepSpeech2's shape, PERF.md §6).
// The k-steps are summed in a fixed order, as in the fp32 form, so that a
// graph replay equals the eager call bit for bit; the sums differ from
// the cluster kernel's and the twin's in their order and rounding.
// DeepSpeech2 (B = 64, H = 1024, two directions): Uc = 16, RB = 64, KS = 1,
// 64 unit blocks x 1 row block x 2 directions = 128 CTAs of 8 warps, 131,072
// bytes of weights a CTA; a step moves 16 rows x 1024 x 2 bytes of h into
// each warp, 32 MiB over the card.  Bound (two directions): LSTM H <= 1056
// at B <= 16, 1208 at B = 64, 792 at B = 128; GRU H <= 1352 at B <= 16,
// 1584 at B = 64, 792 at B = 128; with one direction LSTM H <= 1560, GRU H
// <= 2112 at B <= 16.  Past it the grid.

#pragma once

namespace {

// kWideMaxWarps, kWideSpinLimit, kWideMinSmem and the 3xTF32 and exchange
// primitives are bwd_wide.cuh's, which bwd_hoist.cuh includes
constexpr int kWideDepth = 8;  // k-steps of h in flight a warp

// whether the wide kernel's products are bf16 (wide_bf16): bf16 streams
// whose h is rounded before the product
template <typename S, bool kRound>
constexpr bool kWideBf16 = kRound && std::is_same<S, __nv_bfloat16>::value;
// bytes of a resident weight
template <typename S, bool kRound>
constexpr int kWideWeightBytes = kWideBf16<S, kRound> ? 2 : 4;

struct WideShape {
  int uc, nj, rb, nr, ks, warps, nks;
  size_t smem;  // what the CTA uses; a launch asks for kWideMinSmem at least
  bool ok;
  bool stage;  // the one-gate cell stages h through shared memory
};

// The wide branch's shape for G gates, H, B and ndir on a card of `sms` SMs
// with weights of `wbytes` bytes (see the header); ok is false where no
// shape holds.
inline WideShape wide_shape(int gates, int H, int B, int ndir, int sms,
                            int wbytes) {
  WideShape best{0, 0, 0, 0, 0, 0, (H + 7) / 8, 0, false, false};
  const int bp = (B + 15) / 16 * 16;
  long best_work = 0;
  for (int uc = 8; uc <= 8 * best.nks; uc += 8) {
    const int nj = (H + uc - 1) / uc;
    for (int rb = 16; rb <= bp; rb += 16) {
      const int nr = (B + rb - 1) / rb;
      if (ndir * nr * nj > sms) continue;
      const int groups = rb / 16 * (uc / 8);
      if (groups > kWideMaxWarps) break;
      int ks = 1;
      while (ks < 4 && groups * ks < 8 && groups * ks * 2 <= kWideMaxWarps &&
             ks * 2 <= best.nks)
        ks *= 2;
      const size_t smem = (size_t)wbytes * gates * uc * 8 * best.nks +
                          (size_t)1024 * gates * (ks > 1 ? ks : 0) * groups;
      if (smem > (size_t)kMaxSmem) continue;
      const long work = (long)rb * uc;
      if (!best.ok || work < best_work || (work == best_work && uc > best.uc)) {
        best = WideShape{uc, nj, rb, nr, ks, groups * ks, best.nks, smem, true,
                         false};
        best_work = work;
      }
      break;  // a larger RB for this Uc does more work a CTA
    }
  }
  // the one-gate cell's h staged a step, double-buffered, where it fits
  const size_t staged = (size_t)2 * best.rb * 8 * best.nks * sizeof(float);
  if (gates == 1 && best.ok && best.smem + staged <= (size_t)kMaxSmem) {
    best.stage = true;
    best.smem += staged;
  }
  return best;
}

// CTA (units blockIdx.x, rows blockIdx.y, direction blockIdx.z); see the
// header.  hx: the exchange buffer, fp32 [2][ndir][nmt][nks][32][4] (bf16
// products: bf16 [2][ndir][nmt][ceil(nks / 2)][32][8]); flags:
// [ndir][nmt][nks] int32, zero at the launch.  cs: the LSTM training
// forward's cell states, else null.  The tanh backward (TanhBwdCell) reads
// dy as gx and the saved ys as y_in (null for every forward cell) and
// stores dgx as ys.  stage: the one-gate cell's staging of h (WideShape).
template <class Cell, typename S, bool kRound>
__global__ void __launch_bounds__(32 * kWideMaxWarps, 1)
    fwd_wide_kernel(const S* __restrict__ gx, const S* __restrict__ y_in,
                    const float* __restrict__ w, S* __restrict__ ys,
                    S* __restrict__ cs, float* hx, int* flags, int T, int B,
                    int H, int ndir, int uc, int rb, int ks, int stage) {
  constexpr int G = Cell::kGates;
  constexpr int NI = kInPlanes<Cell>;
  constexpr bool kBf = kWideBf16<S, kRound>;  // bf16 products
  static_assert(!kBf || (G > 1 && !kBackward<Cell>), "bf16: the gated cells");
  extern __shared__ float4 wide_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int d = blockIdx.z;
  const int own0 = blockIdx.x * uc;
  // nks: 8-unit blocks (the flags; the fp32 product's k-steps); nkp: the
  // product's k-steps (bf16: 16 units each)
  const int nks = (H + 7) / 8, nmt = (B + 15) / 16, nub = uc / 8;
  const int nkp = kBf ? (nks + 1) / 2 : nks;
  const int groups = rb / 16 * nub;
  const size_t gh = (size_t)G * H;
  // fp32: [nub][G][nks][32] float2; bf16: [nub][G][nks][32] 4-byte words
  // (a k-step of 16 is words 64 kb + 2 lane, + 1; the odd last one 64 kb +
  // lane)
  float2* ws = reinterpret_cast<float2*>(wide_smem);
  const unsigned* wb = reinterpret_cast<const unsigned*>(wide_smem);
  // [2][groups][ks][4 G][32]: each k split's sums (ks > 1)
  float* part = reinterpret_cast<float*>(wide_smem) +
                (size_t)nub * G * nks * 32 * (kBf ? 1 : 2);

  // resident: read along the units (coalesced; the backward's rows of w_hh
  // along k), stored as the B fragments: fp32, lane 4 g + c holds (k = 8 kb
  // + c, 8 kb + c + 4) of column g of n-tile (unit block, gate q); bf16, the
  // pairs of the header; zero past H in both.  Column q H + unit is
  // w_hh[d][k][q H + unit], the backward's w_hh[d][unit][k] (a column of
  // w_hh^T).
  {
    const int hk = 8 * nks, n_w = G * hk * uc, nthreads = blockDim.x;
    float* wf = reinterpret_cast<float*>(ws);
    unsigned short* wh = reinterpret_cast<unsigned short*>(wide_smem);
    auto coords = [&](int idx, int& u, int& k, int& q) {
      q = idx / (uc * hk);
      if constexpr (kBackward<Cell>) {
        k = idx % hk;
        u = idx / hk % uc;
      } else {
        u = idx % uc;
        k = idx / uc % hk;
      }
    };
    for (int idx0 = tid; idx0 < n_w; idx0 += kLoadDepth * nthreads) {
      float v[kLoadDepth];
#pragma unroll
      for (int i = 0; i < kLoadDepth; ++i) {
        const int idx = idx0 + i * nthreads;
        int u, k, q;
        coords(idx, u, k, q);
        const int unit = own0 + u;
        v[i] = idx < n_w && k < H && unit < H
                   ? w[kBackward<Cell>
                           ? ((size_t)d * H + unit) * H + k
                           : ((size_t)d * H + k) * gh + (size_t)q * H + unit]
                   : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kLoadDepth; ++i) {
        const int idx = idx0 + i * nthreads;
        if (idx >= n_w) continue;
        int u, k, q;
        coords(idx, u, k, q);
        const size_t row = ((size_t)(u >> 3) * G + q) * nks * 32;
        if constexpr (kBf) {
          // k-step kb = k / 16, its half k / 8 % 2, lane 4 unit + k % 8 / 2
          const int kb = k >> 4, ln = 4 * (u & 7) + ((k & 7) >> 1);
          const size_t word =
              row + 64 * kb + (2 * kb + 1 < nks ? 2 * ln + ((k >> 3) & 1) : ln);
          wh[2 * word + (k & 1)] = bf16_bits(v[i]);
        } else {
          wf[((row + (size_t)(k >> 3) * 32 + 4 * (u & 7) + (k & 3)) * 2 +
              ((k >> 2) & 1))] = v[i];
        }
      }
    }
  }
  __syncthreads();

  // the warp's (m-tile, unit block, k split); a group past B or H is idle
  const int grp = warp / ks, kh = warp % ks;
  const int mt = blockIdx.y * (rb / 16) + grp / nub;
  const int kb_own = blockIdx.x * nub + grp % nub;  // its unit block
  const bool live = mt < nmt && 8 * kb_own < H;
  const int kpw = (nkp + ks - 1) / ks;
  const int k0 = min(nkp, kh * kpw), k1 = min(nkp, k0 + kpw);
  // the flags of its k-steps: of the 8-unit blocks they cover
  const int f0 = kBf ? 2 * k0 : k0, f1 = kBf ? min(nks, 2 * k1) : k1;
  int* fl = flags + ((size_t)d * nmt + mt) * nks;
  auto block4 = [&](int par, int kb) {  // the 16 bytes a lane of (m-tile, k-step)
    return reinterpret_cast<float4*>(hx) +
           ((((size_t)par * ndir + d) * nmt + mt) * nkp + kb) * 32;
  };
  const float2* wq = ws + (size_t)(grp % nub) * G * nks * 32 + lane;
  const unsigned* wbq = wb + (size_t)(grp % nub) * G * nks * 32;
  float* pp = part + (size_t)grp * ks * 4 * G * 32 + lane;
  const size_t part_par = (size_t)groups * ks * 4 * G * 32;
  // the one-gate cell's staged h: [2][rb / 16][nks][32] float4, the A
  // fragments of the CTA's m-tiles, after the partials
  const int mts = rb / 16, units = mts * nks;
  float4* staged =
      reinterpret_cast<float4*>(part + (ks > 1 ? 2 * part_par : 0));

  // the thread's (row, unit) pairs of the block, p = 2 e + jj: row g + 8 e,
  // unit 2 c + jj, the sums acc[q][p]; the KS splits share them out, split
  // kh doing the gate math of pairs [kh np, kh np + np)
  const int np = 4 / ks, p0 = kh * np;
  const size_t lanes = (size_t)ndir * H;
  float carry[4] = {0.f, 0.f, 0.f, 0.f}, nx[4][NI];
  auto row = [&](int p) { return 16 * mt + g + 8 * (p >> 1); };
  auto unit = [&](int p) { return 8 * kb_own + 2 * c + (p & 1); };
  auto fetch = [&](int t) {  // rows and units past B, H read a clamped address
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= np) break;
      const int p = p0 + i;
      const bool ok = row(p) < B && unit(p) < H;
      const size_t o = ((size_t)t * B + (ok ? row(p) : 0)) * ndir * gh +
                       d * gh + (ok ? unit(p) : 0);
#pragma unroll
      for (int q = 0; q < G; ++q) nx[i][q] = load_f(gx + o + (size_t)q * H);
      // plane G (the backward's saved y) has gx's layout, as G = 1
      if constexpr (NI > G) nx[i][G] = load_f(y_in + o);
    }
  };
  if (live) fetch(step_time<Cell>(0, d, T));
  FWD_STAMP_START

  for (int s = 0; s < T; ++s) {
    const int t = step_time<Cell>(s, d, T);
    float acc[G][4];
#pragma unroll
    for (int q = 0; q < G; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
    // one k-step of the product: the A fragment a (h or dpre of 16 rows x 8
    // units, split here) times the warp's G n-tiles of k-step kb
    auto kstep = [&](const unsigned* ah, const unsigned* al, int kb) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float2 bv = wq[((size_t)q * nks + kb) * 32];
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(bv.x, bh0, bl0);
        split_tf32(bv.y, bh1, bl1);
        mma_tf32(acc[q], al, bh0, bh1);
        mma_tf32(acc[q], ah, bl0, bl1);
        mma_tf32(acc[q], ah, bh0, bh1);
      }
    };
    // the bf16 product's B fragments of k-step kb for the G gates (the
    // second register zero in a half k-step), and one k-step of 16: h of 16
    // rows x 16 units (its second half zero past the last 8-unit block)
    // times the G n-tiles
    auto bfrag = [&](unsigned (*bf)[2], int kb) {
      const bool full = 2 * kb + 1 < nks;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const unsigned* r =
            wbq + (size_t)q * nks * 32 + 64 * kb + (full ? 2 * lane : lane);
        if (full) {
          const uint2 bv = *reinterpret_cast<const uint2*>(r);
          bf[q][0] = bv.x;
          bf[q][1] = bv.y;
        } else {
          bf[q][0] = r[0];
          bf[q][1] = 0u;
        }
      }
    };
    auto kstep_bf16 = [&](const float4& v, const unsigned (*bf)[2], int kb) {
      const bool full = 2 * kb + 1 < nks;
      const unsigned a[4] = {__float_as_uint(v.x), __float_as_uint(v.y),
                             full ? __float_as_uint(v.z) : 0u,
                             full ? __float_as_uint(v.w) : 0u};
#pragma unroll
      for (int q = 0; q < G; ++q) mma_bf16(acc[q], a, bf[q][0], bf[q][1]);
    };
    auto split4 = [](const float4& v, unsigned* ah, unsigned* al) {
      split_tf32(v.x, ah[0], al[0]);
      split_tf32(v.y, ah[1], al[1]);
      split_tf32(v.z, ah[2], al[2]);
      split_tf32(v.w, ah[3], al[3]);
    };
    if (G == 1 && stage && s > 0) {
      // the one-gate cell: the CTA's warps copy h_{s-1} of its m-tiles, each
      // k-step of each m-tile once, from the exchange buffer into shared
      // memory (one flag wait and one L2 load a k-step and m-tile, where
      // the unit blocks of an m-tile would each load all of it), then meet
      const int nw = blockDim.x >> 5;
      float4* dst = staged + (size_t)(s & 1) * units * 32 + lane;
      auto mt_of = [&](int u) { return (int)blockIdx.y * mts + u / nks; };
      for (int j = lane; warp + nw * j < units; j += 32) {
        const int u = warp + nw * j;
        if (mt_of(u) >= nmt) continue;
        const int* f = flags + ((size_t)d * nmt + mt_of(u)) * nks + u % nks;
        int spins = 0;
        while (ld_acquire(f) < ks * s)
          if (++spins > kWideSpinLimit) __trap();
      }
      __syncwarp();
      for (int u0 = warp; u0 < units; u0 += nw * kWideDepth) {
        float4 v[kWideDepth];
#pragma unroll
        for (int i = 0; i < kWideDepth; ++i) {
          const int u = u0 + nw * i;
          if (u < units && mt_of(u) < nmt)
            v[i] = ld_exchange(reinterpret_cast<const float4*>(hx) +
                               ((((size_t)((s + 1) & 1) * ndir + d) * nmt +
                                 mt_of(u)) * nks + u % nks) * 32 + lane);
        }
#pragma unroll
        for (int i = 0; i < kWideDepth; ++i) {
          const int u = u0 + nw * i;
          if (u < units && mt_of(u) < nmt) dst[(size_t)u * 32] = v[i];
        }
      }
      __syncthreads();
      FWD_STAMP(0)  // the flags and the staging
      if (live) {
        const float4* src =
            staged + ((size_t)(s & 1) * units + (size_t)(grp / nub) * nks) * 32 +
            lane;
        for (int kb = k0; kb < k1; ++kb) {
          unsigned ah[4], al[4];
          split4(src[(size_t)kb * 32], ah, al);
          kstep(ah, al, kb);
        }
      }
    } else if (live && s > 0 && k0 < k1) {  // h_{-1} = 0: no product at s = 0
      // h_{s-1} of every k-step of the split is published: each of the KS
      // writers of a block adds one to its flag a step
      wait_flags(fl + f0, f1 - f0, ks * s, lane);
      FWD_STAMP(0)  // the flags
      const float4* src = block4((s + 1) & 1, 0) + lane;
      float4 ring[kWideDepth];
#pragma unroll
      for (int i = 0; i < kWideDepth; ++i)
        if (k0 + i < k1) ring[i] = ld_exchange(src + (size_t)(k0 + i) * 32);
      if constexpr (kBf) {
        // each k-step's B fragments are read a k-step ahead, before the next
        // load of h (whose memory clobber no shared load may cross), and
        // the whole chunks of kWideDepth k-steps run unpredicated
        unsigned bq[G][2], bn[G][2];
        bfrag(bq, k0);
        auto step = [&](float4& slot, int kb) {
          const float4 v = slot;
          if (kb + 1 < k1) bfrag(bn, kb + 1);
          if (kb + kWideDepth < k1)
            slot = ld_exchange(src + (size_t)(kb + kWideDepth) * 32);
          kstep_bf16(v, bq, kb);
#pragma unroll
          for (int q = 0; q < G; ++q) {
            bq[q][0] = bn[q][0];
            bq[q][1] = bn[q][1];
          }
        };
        int kb0 = k0;
        for (; kb0 + kWideDepth <= k1; kb0 += kWideDepth) {
#pragma unroll
          for (int i = 0; i < kWideDepth; ++i) step(ring[i], kb0 + i);
        }
#pragma unroll
        for (int i = 0; i < kWideDepth; ++i)
          if (kb0 + i < k1) step(ring[i], kb0 + i);
      } else {
        for (int kb0 = k0; kb0 < k1; kb0 += kWideDepth) {
#pragma unroll
          for (int i = 0; i < kWideDepth; ++i) {
            const int kb = kb0 + i;
            if (kb < k1) {
              unsigned ah[4], al[4];
              split4(ring[i], ah, al);
              if (kb + kWideDepth < k1)
                ring[i] = ld_exchange(src + (size_t)(kb + kWideDepth) * 32);
              kstep(ah, al, kb);
            }
          }
        }
      }
    }
    FWD_STAMP(1)  // the product
    if (!live) continue;
    // acc[q][i] becomes the sums of this split's pair p0 + i: with KS > 1
    // every split's sums meet in shared memory and are added in kh order
    if (ks > 1) {
      float* p = pp + (size_t)(s & 1) * part_par;
#pragma unroll
      for (int q = 0; q < G; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[((size_t)kh * 4 * G + 4 * q + i) * 32] = acc[q][i];
      named_sync(1 + grp, 32 * ks);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= np) break;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          float sum = p[(size_t)(4 * q + p0 + i) * 32];
          for (int x = 1; x < ks; ++x)
            sum += p[((size_t)x * 4 * G + 4 * q + p0 + i) * 32];
          acc[q][i] = sum;
        }
      }
    }
    FWD_STAMP(2)  // the splits' barrier and sum

    float hv[4], cv[4], hxv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= np) break;
      const int p = p0 + i;
      float hh[G];
#pragma unroll
      for (int q = 0; q < G; ++q) hh[q] = acc[q][i];
      hv[i] = cell_fwd(Cell{}, hh, nx[i], &carry[i], &cv[i]);
      // past B or H the exchanged value is zero: it meets zero weights
      hxv[i] = row(p) < B && unit(p) < H
                   ? (kRound ? round_to(hv[i], ys) : hv[i])
                   : 0.f;
    }
    FWD_STAMP(3)  // the gate math
    if (s + 1 < T) {
      if constexpr (kBf) {
        // h_s into the buffer as bf16: pair p = 2 e + jj of the block is
        // half jj of word 2 (kb_own % 2) + e of lane 4 g + c's 16 bytes of
        // k-step kb_own / 2 (the header)
        unsigned* dst = reinterpret_cast<unsigned*>(block4(s & 1, kb_own >> 1) +
                                                    lane) +
                        2 * (kb_own & 1);
        if (np == 4) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(
              pack2_bf16(hxv[0], hxv[1], 2), pack2_bf16(hxv[2], hxv[3], 2));
        } else if (np == 2) {
          dst[p0 >> 1] = pack2_bf16(hxv[0], hxv[1], 2);
        } else {
          reinterpret_cast<unsigned short*>(dst + (p0 >> 1))[p0 & 1] =
              bf16_bits(hxv[0]);
        }
      } else {
        // h_s into the buffer: unit 2 c + jj of the block is the A
        // fragment's column (2 c + jj) % 4 of half c / 2, row g + 8 e its
        // element e of that half
        float* dst = reinterpret_cast<float*>(block4(s & 1, kb_own));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i >= np) break;
          const int p = p0 + i, e = p >> 1, jj = p & 1;
          dst[(4 * g + ((2 * c + jj) & 3)) * 4 + e + 2 * (c >> 1)] = hxv[i];
        }
      }
      // each of the KS splits adds one to the block's flag
      __threadfence();
      __syncwarp();
      if (lane == 0) red_release_add(fl + kb_own, 1);
      fetch(step_time<Cell>(s + 1, d, T));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= np) break;
      const int p = p0 + i;
      if (row(p) >= B || unit(p) >= H) continue;
      const size_t o = ((size_t)t * B + row(p)) * lanes + (size_t)d * H + unit(p);
      store_f(ys + o, hv[i]);
      if (cs != nullptr) store_f(cs + o, cv[i]);
    }
    FWD_STAMP(4)  // the exchange, the flag and the stores
  }
}

// the exchange buffer (floats) and the flags (ints) of a wide launch
inline size_t wide_hx_floats(int B, int H, int ndir) {
  return (size_t)2 * ndir * ((B + 15) / 16 * 16) * ((H + 7) / 8 * 8);
}
// the bf16 products' exchange buffer (bf16 elements): H rounded up to 16
inline size_t wide_hx_bf16(int B, int H, int ndir) {
  return (size_t)2 * ndir * ((B + 15) / 16 * 16) * ((H + 15) / 16 * 16);
}
inline size_t wide_flag_ints(int B, int H, int ndir) {
  return (size_t)ndir * ((B + 15) / 16) * ((H + 7) / 8);
}

// Whether the wide branch holds the shape on the current device: a shape
// exists and all its CTAs can be resident at once (one an SM).  Raises the
// kernel's dynamic shared memory limit, so that no launch needs it.
template <class Cell, typename S, bool kRound>
cudaError_t wide_fits(int B, int H, int ndir, bool* fit) {
  *fit = false;
  int device = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  const WideShape ws = wide_shape(Cell::kGates, H, B, ndir, sms,
                                  kWideWeightBytes<S, kRound>);
  if (!coop || !ws.ok) return cudaSuccess;
  const void* kernel = reinterpret_cast<const void*>(fwd_wide_kernel<Cell, S, kRound>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, 32 * ws.warps,
      ws.smem > kWideMinSmem ? ws.smem : kWideMinSmem);
  if (err != cudaSuccess) return err;
  *fit = per_sm * sms >= ndir * ws.nr * ws.nj;
  return cudaSuccess;
}

// Launch the wide branch (fwd_branch chose it for the shape): zero the
// flags on the stream, then one cooperative launch.  hx and flags as
// wide_hx_floats and wide_flag_ints count them; cs and y_in as
// fwd_wide_kernel (the tanh backward passes dy as gx and dgx as ys).
template <class Cell, typename S, bool kRound>
cudaError_t launch_fwd_wide(const void* gx, const void* w, void* ys, void* cs,
                            void* hx, void* flags, int T, int B, int H,
                            int ndir, cudaStream_t stream,
                            const void* y_in = nullptr) {
  if (hx == nullptr || flags == nullptr) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const WideShape ws = wide_shape(Cell::kGates, H, B, ndir, sms,
                                  kWideWeightBytes<S, kRound>);
  if (!ws.ok) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(flags, 0, wide_flag_ints(B, H, ndir) * sizeof(int),
                        stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ws.nj, ws.nr, ndir);
  cfg.blockDim = dim3(32 * ws.warps);
  cfg.dynamicSmemBytes = ws.smem > kWideMinSmem ? ws.smem : kWideMinSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fwd_wide_kernel<Cell, S, kRound>,
                           static_cast<const S*>(gx),
                           static_cast<const S*>(y_in),
                           static_cast<const float*>(w), static_cast<S*>(ys),
                           static_cast<S*>(cs), static_cast<float*>(hx),
                           static_cast<int*>(flags), T, B, H, ndir, ws.uc,
                           ws.rb, ws.ks, (int)ws.stage);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
