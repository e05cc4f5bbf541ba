// The wide-batch branch of the LSTM's and GRU's backward serial chain on
// fp32 streams for Hopper (sm_90a), where the fp32 cluster (bwd_fma_kernel,
// bwd_hoist.cuh) cannot place all its clusters at once: B >= 64 at H = 384
// (8 or 16 clusters of 16 one-CTA-per-SM blocks are more than the card
// holds) and H past that cluster's resident bound.  bwd_hoist.cuh includes
// this header after its cells (cell_step) and stamps; its launcher
// (cluster_branch) chooses the branch.  The header also holds what this
// kernel shares with the wide forward (fwd_wide.cuh): the exchange's loads,
// flags and barriers; the 3xTF32 split and product (split_tf32, mma_tf32)
// are bwd_hoist.cuh's, which its fp32 pre-pass uses too.
//
// Replaces, for those shapes (the grid kernels of lstm_bidir_train.cu and
// gru_bidir_train.cu stay the branch past the bound below):
//   ctc_pytorch_tpu/ops/lstm_pallas_train_v2.py:478, the backward
//     pallas_call of lstm_scan_train_v2 (its step after _lstm_prepass);
//   ctc_pytorch_tpu/ops/gru_pallas_v2.py:382, the backward pallas_call of
//     gru_scan_train_v2 (its step after the pre-pass).
// The function is the grid kernels' and the serial twins', over the same
// pre-pass planes (bwd_hoist.cuh): direction 0 from t = T-1 down,
// direction 1 from t = 0 up; dh_t = dy[t] + dh; the LSTM's dct = dc + dh_t
// A, dpre = [dct Gi, dct Gf, dct Gg, dh_t Go] -> dgx, dc = dct F; the GRU's
// dgx = [dpre_r | dpre_z | dpre_n], dhhn = dh_t P_hn, the product over
// [dpre_r, dpre_z, dhh_n] and dh_t Z added after its sum; then dh = dpre @
// w_hh^T.  The planes, the carries and the element-wise math are fp32.
//
// What bounds it: at (T = 80, B = 128, H = 384, two directions) a step is
// 151 M fp32 multiply-adds, 24.2 GFLOP a launch: 0.36 ms at 67 TFLOP/s of
// fp32 FMA (0.146 ms for three TF32 passes at 495 TFLOP/s).  The grid
// kernel streams the whole (4H, B) dpre of the step before through shared
// memory in every CTA and ends each step at grid.sync().  So, as the wide
// forward does, the product moves to the tensor cores and the grid barrier
// goes.
//
// The contraction runs over the G H gate columns, not over H: a CTA that
// owns Uc units forms dpre only for its own G Uc columns.  So the CTAs split
// the contraction, not the units (as bwd_fma_kernel does in a cluster):
// CTA (j, r, d) owns units [j Uc, j Uc + Uc) of direction d and RB batch
// rows [r RB, r RB + RB), keeps resident in shared memory the rows of w_hh
// that its gate columns meet, w_hh[d][n][q H + j Uc + u] for all H units
// n, as fp32 in the order of the mma's B fragments (one 8-byte load a lane,
// conflict-free), and a step:
//   1. acquires the step flags of the nj writers of (d, r), sums their nj
//      partials of its RB x Uc block in writer order (plus dy[t]; the GRU
//      also the step before's dh_t Z, kept in the owner's registers) into
//      dh_t, each element-wise thread a (row, 4-unit quad), whose carries
//      (dc; the GRU's dh_t Z) stay in its registers;
//   2. does the cell step, stores dgx (and dhhn) and writes dpre (RB x G Uc)
//      into shared memory in the order of the mma's A fragments (one
//      16-byte load a lane);
//   3. forms the partial dh of all H units, RB x G Uc times G Uc x H, in
//      3xTF32 on mma.sync m16n8k8: warp w takes ntw n-tiles (8 units) of
//      every row, a group of kNg at a time (at most 8 accumulator tiles),
//      over all G Uc / 8 k-steps in order, each
//      k-step's fragments loaded one ahead and the three passes issued term
//      by term over the group's tiles (independent mma back to back); each
//      operand is split x = hi + lo as the wide forward splits it
//      (fwd_wide.cuh), the sums lo_a hi_w + hi_a lo_w + hi_a hi_w in fp32;
//   4. stores each owner's RB x Uc share of a group's partial into a global
//      double buffer (st.global.cg, step parity) as the group ends, then
//      fences and adds one to its writer flag (d, r, j) with a release
//      reduction, a warp at a time.  The next step's planes and dy are
//      loaded before the CTA's barrier, so that they arrive during it.
// Why groups: all of a warp's tiles in one array sized for the widest warp
// take 64 accumulator registers of 168, which leaves the compiler one B
// fragment's registers for every tile, so that each tile runs load, split
// and three dependent mma in turn (on an H100 that product took 18.5k
// cycles a step at the bench shape, 12.4k with the groups;
// tools/probe_bwd_steps.py).
// Exchange volume at the bench shape: each CTA writes 49 KB and reads 49 KB
// a step, 6.3 MB each way over the card; gathering the whole RB x 4H dpre
// into every CTA instead would read 25 MB a step.
//
// Why a slot may be overwritten two steps later: writer j writes parity s &
// 1 at step s, after its flag wait of step s, which acquired every writer's
// flag of step s - 1 for (d, r), the owner's among them.  The owner releases
// its flag of step s - 1 only after its product of step s - 1, which follows
// (across the CTA's barrier) its reads of step s - 2's partials, the last
// reads of that parity.  Flags count the steps (each of the writer's wwarps
// warps adds one a step), so nothing is reset between steps; the launcher
// zeroes them with a memset on the launch's stream before each launch,
// which a CUDA graph replays.  Directions and row blocks never wait on each
// other.  The partials are summed in writer order and the k-steps in order,
// so a graph replay equals the eager call bit for bit.  Spinning needs
// every CTA resident: the launch is cooperative (the runtime refuses a grid
// that cannot be co-resident, and the launcher asks the occupancy first),
// and a spin that outlasts kWideSpinLimit polls traps: a fault, never a
// hang.
//
// The shape (bwd_wide_shape): the Uc (a multiple of 8) and RB (16, 32, 48
// or 64 rows) whose CTAs, ndir x ceil(B / RB) x ceil(H / Uc), fit on the
// card's SMs with the least work a CTA (RB x Uc; ties to the larger Uc,
// which exchanges less), with the weights and two dpre buffers within 227
// KB and at most 12 warps (the writers, ceil(H / 8) / ntw with ntw =
// ceil(ceil(H / 8) / 12), and the element-wise owners, RB Uc / 128).
// Bench LSTM (B = 128, H
// = 384): Uc = 24, RB = 32, 128 CTAs of 12 warps, 147 KB of weights + 24
// KB of dpre; B = 64: Uc = 24, RB = 16, 128 CTAs; GRU (B = 128, H = 256):
// Uc = 32, RB = 16, 128 CTAs of 11 warps, 98 KB + 12 KB.  Shared memory is
// 4 G Uc Hn bytes of weights (Hn = H rounded up to 8) and 8 RB G Uc of
// dpre; a launch asks for at least kWideMinSmem so that two CTAs never
// share an SM.  Bound (the largest H that has a shape), on a 132-SM H100
// with two directions: LSTM H <= 872 at B <= 16, 776 at B = 64, 528 at B =
// 128; GRU H <= 1056 at B <= 64, 672 at B = 128; with one direction LSTM H
// <= 1056, GRU H <= 1176 at B <= 16.  Past it the grid.

#pragma once

namespace {

constexpr int kWideMaxWarps = 12;  // 168 registers a thread
constexpr int kWideSpinLimit = 1 << 24;  // polls of one flag before a trap
constexpr size_t kWideMinSmem = 116 * 1024;  // one CTA an SM
constexpr int kBwdWideMaxMt = 4;  // 16-row m-tiles of a row block

// ---------------------------------------------------------------------------
// shared by both wide kernels
// ---------------------------------------------------------------------------

// 16 bytes of an exchange buffer, through L2 (as __ldcg).  Volatile and
// with a memory clobber, so that the compiler keeps it after the flag's
// acquire: __ldcg is an asm with neither, which the compiler may take to
// read no memory and move.
__device__ __forceinline__ float4 ld_exchange(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}
// 8 bytes into an exchange buffer, through L2
__device__ __forceinline__ void st_exchange2(float* p, float a, float b) {
  asm volatile("st.global.cg.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(a),
               "f"(b)
               : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Lanes [0, n) of the warp wait until flag i of `fl` reaches `target`
// (acquire), then the warp meets; past kWideSpinLimit polls a flag traps.
__device__ __forceinline__ void wait_flags(const int* fl, int n, int target,
                                           int lane) {
  for (int base = 0; base < n; base += 32) {
    if (base + lane < n) {
      int spins = 0;
      while (ld_acquire(fl + base + lane) < target)
        if (++spins > kWideSpinLimit) __trap();
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// the backward serial chain
// ---------------------------------------------------------------------------

struct BwdWideShape {
  int uc, nj, rb, nr, ntw, wwarps, warps;
  size_t smem;  // what the CTA uses; a launch asks for kWideMinSmem at least
  bool ok;
};

// The wide backward's shape for G gates, H, B and ndir on a card of `sms`
// SMs (see the header); ok is false where no shape holds.
inline BwdWideShape bwd_wide_shape(int gates, int H, int B, int ndir,
                                   int sms) {
  BwdWideShape best{0, 0, 0, 0, 0, 0, 0, 0, false};
  const int nt = (H + 7) / 8;  // n-tiles of the product: every unit
  const int ntw = (nt + kWideMaxWarps - 1) / kWideMaxWarps;
  const int wwarps = (nt + ntw - 1) / ntw;
  const int bp = (B + 15) / 16 * 16;
  long best_work = 0;
  for (int uc = 8; uc <= 8 * nt; uc += 8) {
    const int nj = (H + uc - 1) / uc;
    for (int rb = 16; rb <= bp && rb <= 16 * kBwdWideMaxMt; rb += 16) {
      const int nr = (B + rb - 1) / rb;
      if (ndir * nr * nj > sms) continue;
      const int iwarps = (rb * uc / 4 + 31) / 32;
      const size_t smem = (size_t)4 * gates * uc * 8 * nt +
                          (size_t)8 * rb * gates * uc;
      if (iwarps > kWideMaxWarps || smem > (size_t)kMaxSmem)
        break;  // a larger RB needs more
      const long work = (long)rb * uc;
      if (!best.ok || work < best_work || (work == best_work && uc > best.uc)) {
        best = BwdWideShape{uc, nj, rb, nr, ntw, wwarps,
                            wwarps > iwarps ? wwarps : iwarps, smem, true};
        best_work = work;
      }
      break;  // a larger RB for this Uc does more work a CTA
    }
  }
  return best;
}

// the exchange buffer (floats) and the flags (ints) of a launch of shape s:
// [2][ndir][nr][nj owner][nj writer][RB][Uc] and [ndir][nr][nj writer]
inline size_t bwd_wide_exchange_floats(const BwdWideShape& s, int ndir) {
  return (size_t)2 * ndir * s.nr * s.nj * s.nj * s.rb * s.uc;
}
inline size_t bwd_wide_flag_ints(const BwdWideShape& s, int ndir) {
  return (size_t)ndir * s.nr * s.nj;
}

// CTA (units blockIdx.x, rows blockIdx.y, direction blockIdx.z) with kMt =
// RB / 16; see the header.  planes (ndir, T, P, B, Hp), w = w_hh (ndir, H, G
// H), dy (T, B, ndir H), dgx (T, B, ndir G H) and the GRU's dhhn (T, B, ndir
// H; null for the LSTM), all fp32; xbuf and flags as bwd_wide_exchange_floats
// and bwd_wide_flag_ints count them, the flags zero at the launch.  vec4:
// dy, dgx and dhhn rows are 16-byte aligned at every 4th unit.
template <class Cell, int kMt>
__global__ void __launch_bounds__(32 * kWideMaxWarps, 1)
    bwd_wide_kernel(const float* __restrict__ planes,
                    const float* __restrict__ w, const float* __restrict__ dy,
                    float* __restrict__ dgx, float* __restrict__ dhhn,
                    float* xbuf, int* flags, int T, int B, int H, int Hp,
                    int ndir, int uc, int ntw, int wwarps, int vec4) {
  constexpr int G = Cell::kGates;
  constexpr int P = Cell::kPlanes;
  constexpr bool kGru = std::is_same<Cell, GruCell>::value;
  constexpr int RB = 16 * kMt;
  extern __shared__ float4 wide_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int j = blockIdx.x, r = blockIdx.y, d = blockIdx.z;
  const int nj = gridDim.x, nr = gridDim.y;
  const int own0 = j * uc, r0 = r * RB;
  const int nt = (H + 7) / 8, kp = G * uc, nksk = kp / 8;
  const size_t gh = (size_t)G * H;
  float2* ws = reinterpret_cast<float2*>(wide_smem);  // [nt][nksk][32]
  // dpre: [2][kMt][nksk][32] float4, the A fragments of each step parity
  float4* abuf = reinterpret_cast<float4*>(ws + (size_t)nt * nksk * 32);

  // resident: read along the units (coalesced), stored as the B fragments:
  // lane 4 g + c holds (k = 8 kb + c, 8 kb + c + 4) of unit 8 t + g of
  // n-tile t, k = q Uc + u the CTA's gate column q H + own0 + u; zero past
  // H in both
  {
    const int n_w = 8 * nt * kp, nthreads = blockDim.x;
    float* wf = reinterpret_cast<float*>(ws);
    const float* wd = w + (size_t)d * H * gh;
    for (int idx0 = tid; idx0 < n_w; idx0 += kLoadDepth * nthreads) {
      float v[kLoadDepth];
#pragma unroll
      for (int i = 0; i < kLoadDepth; ++i) {
        const int idx = idx0 + i * nthreads;
        const int u = idx % uc, q = idx / uc % G, n = idx / kp;
        v[i] = idx < n_w && n < H && own0 + u < H
                   ? wd[(size_t)n * gh + (size_t)q * H + own0 + u]
                   : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kLoadDepth; ++i) {
        const int idx = idx0 + i * nthreads;
        if (idx >= n_w) continue;
        const int k = idx % kp, n = idx / kp;
        wf[((((size_t)(n >> 3) * nksk + (k >> 3)) * 32 + 4 * (n & 7) +
             (k & 3)) << 1) + ((k >> 2) & 1)] = v[i];
      }
    }
    // dpre past B or H stays zero: it meets the weights (0 * NaN is NaN)
    float* af = reinterpret_cast<float*>(abuf);
    for (int idx = tid; idx < 2 * RB * kp; idx += nthreads) af[idx] = 0.f;
  }
  __syncthreads();

  // element-wise work: thread (row, 4-unit quad of the CTA's units)
  const int nq = uc / 4;
  const int row = tid / nq, qd = tid % nq, u = own0 + 4 * qd, b = r0 + row;
  const bool live = tid < RB * nq && b < B && u < H;
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
  // the writers' flags of (d, r); this CTA's own
  int* fl = flags + ((size_t)d * nr + r) * nj;
  // slot (parity, owner, writer): RB x Uc floats
  const size_t slot = (size_t)RB * uc;
  auto slot_at = [&](int par, int owner, int writer) {
    return xbuf + ((((size_t)par * ndir + d) * nr + r) * nj + owner) * nj * slot +
           (size_t)writer * slot;
  };
  // the element-wise thread's A-fragment entries: row g + 8 hi of m-tile
  // row / 16, columns k = q Uc + 4 qd + e are lane 4 g + e, entry hi + 2 khi
  // of k-step (q Uc + 4 qd) / 8, khi = qd & 1
  const int a_lane = 4 * (row & 7), a_ent = (row >> 3 & 1) + 2 * (qd & 1);
  const int a_mt = row >> 4;
  // the product's warp: n-tiles [n0, n1)
  const int n0 = warp * ntw, n1 = min(nt, n0 + ntw);
  const bool writes = warp < wwarps;

  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  fetch(d == 0 ? T - 1 : 0);
  BWD_STAMP_START

  for (int s = 0; s < T; ++s) {
    const int t = d == 0 ? T - 1 - s : s;
    float dh[4] = {0.f, 0.f, 0.f, 0.f};
    if (s > 0 && tid < RB * nq) {
      // every writer's partial of step s - 1 is published
      wait_flags(fl, nj, wwarps * s, lane);
      BWD_STAMP(0)  // the flags
      if (live) {
        const float4* src = reinterpret_cast<const float4*>(
            slot_at((s + 1) & 1, j, 0) + row * uc + 4 * qd);
        float4 v[16];
        for (int w0 = 0; w0 < nj; w0 += 16) {  // in writer order
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (w0 + i < nj) v[i] = ld_exchange(src + (size_t)(w0 + i) * (slot / 4));
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (w0 + i < nj)
              dh[0] += v[i].x, dh[1] += v[i].y, dh[2] += v[i].z, dh[3] += v[i].w;
        }
      }
    }
    BWD_STAMP(1)  // the receive sum

    float4* ab = abuf + (size_t)(s & 1) * kMt * nksk * 32;
    if (live) {
      // dpre[q] enters the product (the GRU's dpre[2] is dhh_n), and dgx
      // gets dpre_n in its place
      float dpre[G][4], dpre_n[4];
      cell_step(Cell{}, nx_pl, nx_dy, dh, carry, dpre, dpre_n);
      float* af = reinterpret_cast<float*>(ab);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        float* ent = af + (((size_t)a_mt * nksk + (q * uc + 4 * qd) / 8) * 32 +
                           a_lane) * 4 + a_ent;
#pragma unroll
        for (int e = 0; e < 4; ++e) ent[4 * e] = e < nu ? dpre[q][e] : 0.f;
      }
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
    BWD_STAMP(2)  // the element-wise step and dgx issued
    if (s + 1 == T) break;
    fetch(d == 0 ? t - 1 : t + 1);
    BWD_STAMP(3)  // the next step's loads issued
    __syncthreads();  // dpre is in shared memory
    BWD_STAMP(4)  // the CTA's barrier
    if (!writes) continue;

    // the partial dh of the warp's n-tiles for every row of the block, kNg
    // n-tiles at a time (at most 8 accumulator tiles), over the CTA's gate
    // columns in k-step order.  Each k-step's fragments are loaded one step
    // ahead, and the three passes go term by term over the group's tiles,
    // so that independent mma issue back to back; each tile still takes
    // lo_a hi_w, hi_a lo_w, hi_a hi_w in that order a k-step.  Each
    // owner's share of a group goes to its slot of this step's parity
    // (units 8 t + 2 c, + 1 of rows g, g + 8 of each m-tile; rows past B
    // and units past H are never read).
    constexpr int kNg = kMt <= 2 ? 4 : 2;
    for (int t0 = n0; t0 < n1; t0 += kNg) {
      float acc[kMt][kNg][4];
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int n = 0; n < kNg; ++n)
          acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
      const float2* wq = ws + (size_t)t0 * nksk * 32 + lane;
      float4 a_nx[kMt];
      float2 b_nx[kNg];
      auto load = [&](int kb) {
#pragma unroll
        for (int m = 0; m < kMt; ++m)
          a_nx[m] = ab[((size_t)m * nksk + kb) * 32 + lane];
#pragma unroll
        for (int n = 0; n < kNg; ++n)
          b_nx[n] = t0 + n < n1 ? wq[((size_t)n * nksk + kb) * 32]
                                : make_float2(0.f, 0.f);
      };
      load(0);
      for (int kb = 0; kb < nksk; ++kb) {
        unsigned ah[kMt][4], al[kMt][4], bh[kNg][2], bl[kNg][2];
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
          split_tf32(a_nx[m].x, ah[m][0], al[m][0]);
          split_tf32(a_nx[m].y, ah[m][1], al[m][1]);
          split_tf32(a_nx[m].z, ah[m][2], al[m][2]);
          split_tf32(a_nx[m].w, ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int n = 0; n < kNg; ++n) {
          split_tf32(b_nx[n].x, bh[n][0], bl[n][0]);
          split_tf32(b_nx[n].y, bh[n][1], bl[n][1]);
        }
        if (kb + 1 < nksk) load(kb + 1);
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int n = 0; n < kNg; ++n)
            if (t0 + n < n1) mma_tf32(acc[m][n], al[m], bh[n][0], bh[n][1]);
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int n = 0; n < kNg; ++n)
            if (t0 + n < n1) mma_tf32(acc[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int n = 0; n < kNg; ++n)
            if (t0 + n < n1) mma_tf32(acc[m][n], ah[m], bh[n][0], bh[n][1]);
      }
#pragma unroll
      for (int n = 0; n < kNg; ++n) {
        const int nu0 = 8 * (t0 + n) + 2 * c;
        if (t0 + n >= n1 || nu0 >= H) continue;
        float* dst = slot_at(s & 1, nu0 / uc, j) + nu0 % uc;
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int rr = 16 * m + g + 8 * hh;
            if (r0 + rr < B)
              st_exchange2(dst + (size_t)rr * uc, acc[m][n][2 * hh],
                           acc[m][n][2 * hh + 1]);
          }
        }
      }
    }
    BWD_STAMP(5)  // the product and the exchange stores
    __threadfence();
    __syncwarp();
    if (lane == 0) red_release_add(fl + j, 1);
    BWD_STAMP(6)  // the fence and the flag
  }
}

template <class Cell>
const void* bwd_wide_kernel_for(int rb) {
  switch (rb / 16) {
    case 1: return reinterpret_cast<const void*>(bwd_wide_kernel<Cell, 1>);
    case 2: return reinterpret_cast<const void*>(bwd_wide_kernel<Cell, 2>);
    case 3: return reinterpret_cast<const void*>(bwd_wide_kernel<Cell, 3>);
    default: return reinterpret_cast<const void*>(bwd_wide_kernel<Cell, 4>);
  }
}

inline cudaError_t device_sms(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// Whether the wide backward holds the shape on the current device: a shape
// exists and all its CTAs can be resident at once (one an SM).  Raises the
// kernel's dynamic shared memory limit, so that no launch needs it.
template <class Cell>
cudaError_t bwd_wide_fits(int B, int H, int ndir, bool* fit) {
  *fit = false;
  int device = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  const BwdWideShape s = bwd_wide_shape(Cell::kGates, H, B, ndir, sms);
  if (!coop || !s.ok) return cudaSuccess;
  const void* kernel = bwd_wide_kernel_for<Cell>(s.rb);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, 32 * s.warps,
      s.smem > kWideMinSmem ? s.smem : kWideMinSmem);
  if (err != cudaSuccess) return err;
  *fit = per_sm * sms >= ndir * s.nr * s.nj;
  return cudaSuccess;
}

// The scratch of a wide launch at this shape on the current device: the
// exchange buffer's floats and the flags' ints (0 where no shape holds).
template <class Cell>
cudaError_t bwd_wide_scratch(int B, int H, int ndir, size_t* floats,
                             size_t* ints) {
  *floats = *ints = 0;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  const BwdWideShape s = bwd_wide_shape(Cell::kGates, H, B, ndir, sms);
  if (s.ok) {
    *floats = bwd_wide_exchange_floats(s, ndir);
    *ints = bwd_wide_flag_ints(s, ndir);
  }
  return cudaSuccess;
}

// Launch the wide backward (cluster_branch chose it for the shape): zero
// the flags on the stream, then one cooperative launch.  xbuf and flags as
// bwd_wide_scratch sizes them; dhhn the GRU's, null for the LSTM.
template <class Cell>
cudaError_t launch_bwd_wide(const void* planes, const void* w, const void* dy,
                            void* dgx, void* dhhn, void* xbuf, void* flags,
                            int T, int B, int H, int Hp, int ndir,
                            cudaStream_t stream) {
  if (xbuf == nullptr || flags == nullptr) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  const BwdWideShape s = bwd_wide_shape(Cell::kGates, H, B, ndir, sms);
  if (!s.ok) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(flags, 0, bwd_wide_flag_ints(s, ndir) * sizeof(int),
                        stream);
  if (err != cudaSuccess) return err;
  auto aligned16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  int vec4 = H % 4 == 0 && aligned16(dy) && aligned16(dgx) &&
             (dhhn == nullptr || aligned16(dhhn));
  int uc = s.uc, ntw = s.ntw, wwarps = s.wwarps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.nj, s.nr, ndir);
  cfg.blockDim = dim3(32 * s.warps);
  cfg.dynamicSmemBytes = s.smem > kWideMinSmem ? s.smem : kWideMinSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&planes, &w,  &dy, &dgx,  &dhhn, &xbuf, &flags,
                  &T,      &B,  &H,  &Hp,   &ndir, &uc,   &ntw,
                  &wwarps, &vec4};
  err = cudaLaunchKernelExC(&cfg, bwd_wide_kernel_for<Cell>(s.rb), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
