// The CTC loss for Hopper (sm_90a): one forward kernel and one backward
// kernel, one CTA per utterance.
//
// Replaces ctc_pytorch_tpu/ops/ctc_pallas.py: ctc_alpha_pallas (kernel
// _alpha_kernel) with _prepare and _ll_from_alphas folded into ctc_fwd, and
// ctc_beta_pallas (kernel _beta_kernel) with the VJP body _neg_ll_pallas_bwd
// folded into ctc_bwd.  Same function, all fp32, log domain with
// NEG_INF = -1e30:
//   log_probs (T, B, C), labels (B, L) int32, input and label lengths (B,)
//   int32; extended labels z = [blank, l1, blank, ..., lL, blank], S = 2L + 1,
//   position s live iff s < 2 * label_len + 1;
//   alpha[0] = emit[0] at s <= 1; alpha[t] = lse3(alpha[t-1, s],
//   alpha[t-1, s-1], alpha[t-1, s-2] if z_s != z_{s-2}) + emit[t], frozen
//   once t >= input_len; ll = logaddexp of the last two live positions of the
//   row at input_len - 1;
//   beta takes the terminal row (emit at the last two live positions) at
//   t = input_len - 1 and walks down with s+1, s+2;
//   gamma = alpha + beta - emit, its frame max gmax, the per-class sums of
//   exp(gamma - gmax), and d(-ll)/dlogp(t, k) = -exp(log gamma_k - ll) * g[b]
//   on frames below input_len, zero elsewhere.
// lse3 pins a cell whose three inputs are all dead to exactly NEG_INF, so an
// utterance whose labels do not fit its frames gets a huge finite loss and
// zero gradients.  expf, logf and the order of every sum in the DPs are the
// plain twin's, so the tables agree with it bit for bit.
//
// What bounds it: neither bytes (an (80, 128, 97) alpha table is 4 MB, ~1.2
// us at 3.35 TB/s) nor operations (~30 fp32 operations a cell) but the T
// serial frames of each utterance: a frame is one dependent chain (the
// neighbours' exchange, three expf, a logf, the adds; ~35 dependent
// instructions, the accurate logf alone ~20 of them).  The old pair of
// kernels read emit from device memory inside that chain and left ~40 small
// PyTorch ops around it (the class gather, the gamma tables, a scatter_add_
// with atomics).  The math stays the twin's: with faster exp and log the
// tables would drift from it by an ulp, which at T = 400 (values near -1500)
// is more than the 1e-4 they are held to.
//
// Design: everything in these two launches.  Each CTA builds the extended
// labels, the skip rule and the position mask from its labels (each DP
// thread owns P consecutive positions, their classes in registers);
// positions at or past 2 * label_len + 1 never read log_probs.  The rows the
// DP needs (log_probs, and the alpha rows in the backward) are staged in
// shared memory ahead of the frame loop through cp.async, in a ring of
// kStages chunks of up to kMaxChunk frames, so no device-memory load sits on
// the serial chain; a row too wide for the ring's budget is read from device
// memory instead (the "unstaged" branches).  One warp issuing four
// positions a lane is latency bound (its instructions depend on each other),
// so a frame's positions are spread one a thread over as many warps as the
// row needs; each thread publishes its new values as soon as they are final
// and collects its neighbours s-1, s-2 (s+1, s+2) at the next frame
// (Exchange), through shared memory and one barrier a frame among the DP
// threads (P = 1 up to 512 positions, then 2 to 32 positions a thread with
// only the edge values exchanged).
// The backward's DP warps walk a chunk of frames through the beta DP and
// leave the chunk's gamma rows in shared memory; kGradWarps warps of their
// own form those frames' gradients, one frame a warp, while the DP warps
// walk the next chunk, so that work stays off the serial chain (where the
// CTA has no room for them, the DP warps form them after each chunk).
// The per-class sums are taken in a fixed order, without atomics: the blank
// class (and any label equal to it) over its positions, lane by lane in a
// fixed reduction tree; each label class by its first position, walking a
// "next position with the same class" list built once per utterance.  So two
// calls give bit-equal gradients.  Every gradient entry is written (the
// frame's row zeroed, then the present classes), so no zero-fill launch is
// needed.  No allocation, no host sync: graph safe.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kStages = 4;  // ring slots; kStages - 1 chunks in flight
constexpr int kMaxChunk = 16;  // frames a chunk
constexpr int kRingBytes = 96 * 1024;  // shared memory for the ring
constexpr int kSmemMax = 227 * 1024;  // a CTA's shared memory on sm_90
constexpr int kMaxThreads = 1024;
constexpr int kGradWarps = 8;  // backward: gradient warps beside the DP's

struct CtcArgs {
  const float* lp;  // (T, B, C)
  const int* labels;  // (B, L)
  const int* in_len;  // (B,)
  const int* lab_len;  // (B,)
  const float* alphas_in;  // backward: (T, B, S)
  const float* neg_ll_in;  // backward: (B,)
  const float* g;  // backward: (B,)
  float* alphas;  // forward: (T, B, S) or null
  float* neg_ll;  // forward: (B,)
  float* grad;  // backward: (T, B, C)
  float* betas;  // backward: (T, B, S) or null
  int T, B, C, L, S, blank;
  int dp_threads;  // threads that own positions (a multiple of 32)
  int chunk;  // frames a chunk
  int staged;  // rows staged in the ring (else read from device memory)
  int grad_warps;  // backward: warps forming gradients
  int split;  // backward: the gradient warps are warps of their own, one
              // chunk behind the DP warps (else all warps, after them)
};

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float m_safe = fmaxf(m, kNegInf / 2);
  const float s = expf(a - m_safe) + expf(b - m_safe) + expf(c - m_safe);
  const float r = m_safe + logf(fmaxf(s, 1e-37f));
  return m <= kNegInf / 2 ? kNegInf : r;
}

// torch.logaddexp's formula
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Barrier 1 over the first nt threads: the DP threads' barrier, which the
// backward's gradient warps do not join.
__device__ __forceinline__ void dp_sync(int nt) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

// a butterfly: every lane ends with the same bits (fp32 addition commutes)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

__device__ __forceinline__ int clamp_class(int k, int C) {
  return k < 0 ? 0 : (k >= C ? C - 1 : k);
}

// Shared memory, in floats:
//   xch   [4 * nt]                the DP's exchange (rows or edge pairs)
//   fin   [4]                     the final alpha row's last two live cells
//   ring  [kStages][chunk][width] log_probs rows (+ alpha rows, backward)
//   gbuf  [2 or 1][chunk][S]      backward: gamma rows of a chunk (two
//                                 chunks when split)
//   wl    [grad_warps][L]         backward: exp(gamma - gmax) of each label
//   link  [L] ushort              backward: bit 15 first of its class,
//                                 bit 14 equal to blank, bits 0-13 the next
//                                 label of the class + 1 (0: none)
struct Smem {
  float* xch;
  float* fin;
  float* ring;
  float* gbuf;
  float* wl;
  unsigned short* link;
};

__host__ __device__ __forceinline__ size_t smem_floats(const CtcArgs& a,
                                                       int width,
                                                       bool backward,
                                                       Smem* m, float* base) {
  const size_t n_xch = 4 * (size_t)a.dp_threads, n_fin = 4;
  const size_t n_ring = a.staged ? (size_t)kStages * a.chunk * width : 0;
  const int S = a.S, L = a.L, grad_warps = a.grad_warps;
  const size_t n_gbuf = backward ? (size_t)(a.split ? 2 : 1) * a.chunk * S : 0;
  const size_t n_wl = backward ? (size_t)grad_warps * L : 0;
  const size_t n_link = backward ? ((size_t)L + 1) / 2 : 0;
  if (m != nullptr) {
    m->xch = base;
    m->fin = m->xch + n_xch;
    m->ring = m->fin + n_fin;
    m->gbuf = m->ring + n_ring;
    m->wl = m->gbuf + n_gbuf;
    m->link = reinterpret_cast<unsigned short*>(m->wl + n_wl);
  }
  return n_xch + n_fin + n_ring + n_gbuf + n_wl + n_link;
}

// Positions owned by a DP thread and their constants.
template <int P>
struct Positions {
  int s0;  // first position
  int cls[P];  // class of each position (clamped into [0, C))
  unsigned live, skip;  // bit k: s0 + k live; skip allowed into (forward)
                        // or out of (backward) it
};

template <int P>
__device__ __forceinline__ Positions<P> positions(const CtcArgs& a, int b,
                                                  int sl, bool backward) {
  Positions<P> q;
  q.s0 = threadIdx.x * P;
  q.live = q.skip = 0u;
  const int* lab = a.labels + (size_t)b * a.L;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int s = q.s0 + k;
    int cls = a.blank;
    bool skip = false;
    if (s < sl) {
      if (s & 1) {
        const int j = s >> 1;
        const int z = __ldg(lab + j);
        cls = clamp_class(z, a.C);
        // forward: into s from s - 2; backward: out of s into s + 2
        skip = backward ? (s + 2 >= a.S || __ldg(lab + j + 1) != z)
                        : (j == 0 || __ldg(lab + j - 1) != z);
      } else {
        skip = backward && s + 2 >= a.S;
      }
      q.live |= 1u << k;
    }
    q.cls[k] = cls;
    q.skip |= (unsigned)skip << k;
  }
  return q;
}

// Issue the cp.async copies of chunk c: frames frame0 + dir * f for f in
// [c * chunk, (c + 1) * chunk) within [0, n_frames) of the walk, log_probs
// rows (C wide) and, with al, alpha rows (S wide) after them in the slot;
// by the first nt threads, each copying fixed columns down the frames.
__device__ __forceinline__ void issue_chunk(const CtcArgs& a, float* ring,
                                            int nt, int width, int b, int c,
                                            int n_frames, int frame0, int dir,
                                            const float* al) {
  float* slot = ring + (size_t)(c % kStages) * a.chunk * width;
  const int f0 = c * a.chunk;
  const int nf = min(a.chunk, n_frames - f0);
  const size_t row0 = (size_t)(frame0 + dir * f0) * a.B + b;
  const ptrdiff_t step = (ptrdiff_t)dir * a.B;  // rows from frame to frame
  for (int k = threadIdx.x; k < a.C; k += nt) {
    const float* src = a.lp + row0 * a.C + k;
    for (int f = 0; f < nf; ++f, src += step * a.C)
      cp_async4(slot + f * a.C + k, src);
  }
  if (al != nullptr) {
    float* aslot = slot + a.chunk * a.C;
    for (int s = threadIdx.x; s < a.S; s += nt) {
      const float* src = al + row0 * a.S + s;
      for (int f = 0; f < nf; ++f, src += step * a.S)
        cp_async4(aslot + f * a.S + s, src);
    }
  }
}

// Staged rows, by the first nt threads: issue the chunk kStages - 1 ahead
// of chunk c (into the slot of chunk c - 1, which they have all read) and
// wait for their copies of chunk c; the caller then syncs them.
__device__ __forceinline__ void ring_chunk(const CtcArgs& a, float* ring,
                                           int nt, int width, int b, int c,
                                           int n_chunks, int n_frames,
                                           int frame0, int dir,
                                           const float* al) {
  if (c == 0) {
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_chunks)
        issue_chunk(a, ring, nt, width, b, k, n_frames, frame0, dir, al);
      cp_async_commit();
    }
  }
  if (c + kStages - 1 < n_chunks)
    issue_chunk(a, ring, nt, width, b, c + kStages - 1, n_frames, frame0, dir,
                al);
  cp_async_commit();
  cp_async_wait_ring();
}

// The DP threads' exchange of the row of one frame, in two halves:
// publish() right after a thread's row values are final, collect() at the
// next frame, which returns the values at s0 - 1, s0 - 2 (forward) or
// s0 + P, s0 + P + 1 (backward).  Between them a thread issues the work that
// does not depend on its neighbours.  Shared-memory rows (or edge pairs)
// alternate by frame parity, so one barrier a frame suffices: a thread
// rewrites a buffer only after the next frame's barrier, which every reader
// of it has passed.
template <int P, bool FWD>
struct Exchange {
  float* xch;
  int nt;  // DP threads

  __device__ __forceinline__ void publish(const float (&v)[P],
                                          int parity) const {
    if constexpr (P == 1) {
      xch[parity * nt + threadIdx.x] = v[0];
    } else {
      reinterpret_cast<float2*>(xch)[parity * nt + threadIdx.x] =
          FWD ? make_float2(v[P - 2], v[P - 1]) : make_float2(v[0], v[1]);
    }
  }

  __device__ __forceinline__ void collect(const float (&v)[P], int parity,
                                          float* n1, float* n2) const {
    const int tid = threadIdx.x;
    dp_sync(nt);
    if constexpr (P == 1) {
      const float* row = xch + parity * nt;
      if constexpr (FWD) {
        *n1 = tid >= 1 ? row[tid - 1] : kNegInf;
        *n2 = tid >= 2 ? row[tid - 2] : kNegInf;
      } else {
        *n1 = tid + 1 < nt ? row[tid + 1] : kNegInf;
        *n2 = tid + 2 < nt ? row[tid + 2] : kNegInf;
      }
    } else {
      const float2* edge = reinterpret_cast<const float2*>(xch) + parity * nt;
      if constexpr (FWD) {
        const float2 lo =
            tid > 0 ? edge[tid - 1] : make_float2(kNegInf, kNegInf);
        *n1 = lo.y;
        *n2 = lo.x;
      } else {
        const float2 hi =
            tid + 1 < nt ? edge[tid + 1] : make_float2(kNegInf, kNegInf);
        *n1 = hi.x;
        *n2 = hi.y;
      }
    }
  }
};

// A thread's positions of one row: at their classes (BY_CLASS) or at the
// positions themselves (clamped into the row, for threads past its end).
// Dead positions load a valid entry too, which the DP masks: the loads
// carry no branch.
template <int P, bool BY_CLASS>
__device__ __forceinline__ void gather_row(const Positions<P>& q,
                                           const float* row, int S,
                                           float (&out)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k)
    out[k] = row[BY_CLASS ? q.cls[k] : min(q.s0 + k, S - 1)];
}

// The alpha walk over frames [0, n_frames) of one utterance: log_probs rows
// from the ring (STAGED) or device memory.
template <int P, bool STAGED>
__device__ __forceinline__ void alpha_walk(const CtcArgs& a, const Smem& sm,
                                           const Positions<P>& q, int b,
                                           int n_frames, float (&v)[P]) {
  const int nt = blockDim.x, S = a.S;
  const Exchange<P, true> x{sm.xch, nt};
  const size_t row_step = (size_t)a.B * a.C;
  const int n_chunks = (n_frames + a.chunk - 1) / a.chunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * a.chunk, t1 = min(t0 + a.chunk, n_frames);
    const float* lrow;
    if constexpr (STAGED) {
      ring_chunk(a, sm.ring, nt, a.C, b, c, n_chunks, n_frames, 0, 1, nullptr);
      __syncthreads();
      lrow = sm.ring + (size_t)(c % kStages) * a.chunk * a.C;
    } else {
      lrow = a.lp + ((size_t)t0 * a.B + b) * a.C;
    }
    float* out = a.alphas == nullptr ? nullptr
                                     : a.alphas + ((size_t)t0 * a.B + b) * S;
    for (int t = t0; t < t1; ++t) {
      float e[P];
      gather_row<P, true>(q, lrow, S, e);
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < P; ++k)
          v[k] = ((q.live >> k) & 1u) && q.s0 + k <= 1 ? e[k] : kNegInf;
      } else {
        float up1, up2;  // alpha[t-1] at s0 - 1 and s0 - 2
        x.collect(v, (t - 1) & 1, &up1, &up2);
#pragma unroll
        for (int k = P - 1; k >= 0; --k) {  // in place: v[k-1], v[k-2] old
          const float p1 = k >= 1 ? v[k - 1] : up1;
          const float p2 = k >= 2 ? v[k - 2] : (k == 1 ? up1 : up2);
          const float c2 = (q.skip >> k) & 1u ? p2 : kNegInf;
          const float r = lse3(v[k], p1, c2) + e[k];
          v[k] = (q.live >> k) & 1u ? r : kNegInf;
        }
      }
      x.publish(v, t & 1);
      if (out != nullptr) {
#pragma unroll
        for (int k = 0; k < P; ++k)
          if (q.s0 + k < S) out[q.s0 + k] = v[k];
        out += (size_t)a.B * S;
      }
      lrow += STAGED ? a.C : row_step;
    }
    if constexpr (STAGED) __syncthreads();  // the slot is refilled next chunk
  }
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads) ctc_fwd_kernel(CtcArgs a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = a.T, S = a.S;
  const int n = a.in_len[b];
  const int sl = min(2 * min(a.lab_len[b], a.L) + 1, S);
  // frames the DP computes: row 0 always, rows below input_len after it
  const int n_frames = max(1, min(n, T));
  Smem sm;
  smem_floats(a, a.C, false, &sm, reinterpret_cast<float*>(smem4));
  const Positions<P> q = positions<P>(a, b, sl, false);
  float v[P];
  if (a.staged)
    alpha_walk<P, true>(a, sm, q, b, n_frames, v);
  else
    alpha_walk<P, false>(a, sm, q, b, n_frames, v);
  // ll from the last computed row, which the frozen rows repeat
  const int idx_last = max(sl - 1, 0), idx_prev = max(sl - 2, 0);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (q.s0 + k == idx_last) sm.fin[0] = v[k];
    if (q.s0 + k == idx_prev) sm.fin[1] = v[k];
  }
  __syncthreads();
  if (tid == 0) {
    const float a_prev = sl >= 2 ? sm.fin[1] : kNegInf;
    a.neg_ll[b] = -logaddexp(sm.fin[0], a_prev);
  }
  if (a.alphas != nullptr) {
    for (int t = n_frames; t < T; ++t) {
      float* out = a.alphas + ((size_t)t * a.B + b) * S;
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (q.s0 + k < S) out[q.s0 + k] = v[k];
    }
  }
}

// One frame's gradient row by one warp, from the frame's gamma row (dead
// positions at NEG_INF): the frame max, the blank sum (lane by lane in
// position order, then a fixed butterfly), the label classes through their
// chains, every entry of grad[t, b, :] written.
__device__ __forceinline__ void grad_frame(const CtcArgs& a, const int* lab,
                                           const float* grow, float* wl,
                                           const unsigned short* link,
                                           float* gr, int sl, int ll_len,
                                           float ll, float gb) {
  const int lane = threadIdx.x & 31;
  // the lane's first label class, loaded ahead of its use by a head
  const int z0 = lane < ll_len ? __ldg(lab + lane) : 0;
  float gmax = kNegInf;
  for (int s = lane; s < sl; s += 32) gmax = fmaxf(gmax, grow[s]);
  gmax = fmaxf(warp_max(gmax), kNegInf / 2);
  float blank_sum = 0.f;
  for (int s = lane; s < sl; s += 32) {
    const float w = expf(grow[s] - gmax);
    if (!(s & 1) || (link[s >> 1] & 0x4000))
      blank_sum += w;
    else
      wl[s >> 1] = w;
  }
  blank_sum = warp_sum(blank_sum);
  for (int k = lane; k < a.C; k += 32) gr[k] = 0.f;
  __syncwarp();  // wl, and the zeroed row before the values
  if (lane == 0) {
    const float ld =
        blank_sum > 0.f ? logf(fmaxf(blank_sum, 1e-37f)) : kNegInf;
    gr[a.blank] = -expf(ld + gmax - ll) * gb;
  }
  for (int j = lane; j < ll_len; j += 32) {
    const unsigned short lk = link[j];
    if (!(lk & 0x8000)) continue;  // not the first of its class, or blank
    float dens = wl[j];
    for (int nx = (lk & 0x3fff) - 1; nx >= 0; nx = (link[nx] & 0x3fff) - 1)
      dens += wl[nx];
    const float ld = dens > 0.f ? logf(fmaxf(dens, 1e-37f)) : kNegInf;
    const int z = j == lane ? z0 : __ldg(lab + j);
    gr[clamp_class(z, a.C)] = -expf(ld + gmax - ll) * gb;
  }
  __syncwarp();  // the next frame rewrites wl
}

// The beta walk over the frames of chunk c (walk index f = top - t), by the
// DP threads: log_probs and alpha rows from the ring (STAGED) or device
// memory; each frame's gamma = alpha + beta - emit (NEG_INF where dead) into
// gbuf, beta into the debug table when asked.
template <int P, bool STAGED>
__device__ __forceinline__ void beta_chunk(const CtcArgs& a, const Smem& sm,
                                           const Positions<P>& q, int b,
                                           int c, int n_chunks, int n_frames,
                                           int sl, float* gbuf,
                                           float (&v)[P]) {
  const int S = a.S, C = a.C, top = n_frames - 1;
  const Exchange<P, false> x{sm.xch, a.dp_threads};
  const int f0 = c * a.chunk, f1 = min(f0 + a.chunk, n_frames);
  const float *lrow, *arow;
  if constexpr (STAGED) {
    ring_chunk(a, sm.ring, a.dp_threads, C + S, b, c, n_chunks, n_frames, top,
               -1, a.alphas_in);
    dp_sync(a.dp_threads);
    lrow = sm.ring + (size_t)(c % kStages) * a.chunk * (C + S);
    arow = lrow + a.chunk * C;
  } else {
    lrow = a.lp + ((size_t)(top - f0) * a.B + b) * C;
    arow = a.alphas_in + ((size_t)(top - f0) * a.B + b) * S;
  }
  const ptrdiff_t lstep = STAGED ? C : -(ptrdiff_t)a.B * C;
  const ptrdiff_t astep = STAGED ? S : -(ptrdiff_t)a.B * S;
  float* out = a.betas == nullptr
                   ? nullptr
                   : a.betas + ((size_t)(top - f0) * a.B + b) * S;
  for (int f = f0; f < f1; ++f) {
    float e[P], al[P];
    gather_row<P, true>(q, lrow, S, e);
    gather_row<P, false>(q, arow, S, al);
    if (f == 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int s = q.s0 + k;
        v[k] = s == sl - 1 || s == sl - 2 ? e[k] : kNegInf;
      }
    } else {
      float dn1, dn2;  // beta[t+1] at s0 + P and s0 + P + 1
      x.collect(v, (f - 1) & 1, &dn1, &dn2);
#pragma unroll
      for (int k = 0; k < P; ++k) {  // in place: v[k+1], v[k+2] old
        const float n1 = k + 1 < P ? v[k + 1] : dn1;
        const float n2 = k + 2 < P ? v[k + 2] : (k + 1 < P ? dn1 : dn2);
        const float c2 = (q.skip >> k) & 1u ? n2 : kNegInf;
        const float r = lse3(v[k], n1, c2) + e[k];
        v[k] = (q.live >> k) & 1u ? r : kNegInf;
      }
    }
    x.publish(v, f & 1);
    float* grow = gbuf + (size_t)(f - f0) * S;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (q.s0 + k >= S) continue;
      const float gam = al[k] + v[k] - e[k];
      grow[q.s0 + k] = (q.live >> k) & 1u ? gam : kNegInf;
      if (out != nullptr) out[q.s0 + k] = v[k];
    }
    if (out != nullptr) out -= (size_t)a.B * S;
    lrow += lstep;
    arow += astep;
  }
  dp_sync(a.dp_threads);  // the slot of chunk c is refilled next chunk
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads) ctc_bwd_kernel(CtcArgs a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int T = a.T, S = a.S, C = a.C;
  const int n = a.in_len[b];
  const int ll_len = min(a.lab_len[b], a.L);
  const int sl = min(2 * ll_len + 1, S);
  // frames with a gradient: below input_len, where beta has its terminal
  // row; none when input_len is 0 or past T (no terminal row: all dead)
  const int n_frames = n >= 1 && n <= T ? n : 0;
  Smem sm;
  smem_floats(a, C + S, true, &sm, reinterpret_cast<float*>(smem4));
  const int dp_nt = a.dp_threads;
  const bool dp = tid < dp_nt;
  const Positions<P> q = positions<P>(a, b, dp ? sl : 0, true);
  const int* lab = a.labels + (size_t)b * a.L;
  // rows without a gradient: zero, and dead beta rows
  for (int t = n_frames; t < T; ++t) {
    float* gr = a.grad + ((size_t)t * a.B + b) * C;
    for (int k = tid; k < C; k += nt) gr[k] = 0.f;
    if (a.betas != nullptr) {
      float* br = a.betas + ((size_t)t * a.B + b) * S;
      for (int s = tid; s < S; s += nt) br[s] = kNegInf;
    }
  }
  // label chains: each live label that is not blank links to the next live
  // label of its class; the first of a class sums them in order
  for (int j = tid; j < ll_len; j += nt) {
    const int z = clamp_class(__ldg(lab + j), C);
    const bool label = z != a.blank;  // labels equal to blank join its sum
    int nx = -1;
    bool first = label;
    for (int j2 = j + 1; label && j2 < ll_len && nx < 0; ++j2)
      if (clamp_class(__ldg(lab + j2), C) == z) nx = j2;
    for (int j2 = j - 1; first && j2 >= 0; --j2)
      if (clamp_class(__ldg(lab + j2), C) == z) first = false;
    sm.link[j] =
        (unsigned short)((first ? 0x8000 : 0) | (label ? 0 : 0x4000) | (nx + 1));
  }
  const float ll = -a.neg_ll_in[b];
  const float gb = a.g[b];
  const int n_chunks = (n_frames + a.chunk - 1) / a.chunk;
  const int top = n_frames - 1;  // the walk goes top, top - 1, ..., 0
  // split: the gradient warps follow the DP warps, one chunk behind
  const int grad_warp = (tid - (a.split ? dp_nt : 0)) >> 5;
  float v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = kNegInf;
  for (int c = 0; c < n_chunks + a.split; ++c) {
    // the links before the first chunk; with split, the previous chunk's
    // gamma rows, and the gradient warps done with the gamma rows that
    // this chunk overwrites
    __syncthreads();
    if (dp && c < n_chunks) {
      float* gbuf = sm.gbuf + (size_t)(a.split ? c & 1 : 0) * a.chunk * S;
      if (a.staged)
        beta_chunk<P, true>(a, sm, q, b, c, n_chunks, n_frames, sl, gbuf,
                            v);
      else
        beta_chunk<P, false>(a, sm, q, b, c, n_chunks, n_frames, sl, gbuf,
                             v);
    }
    const int gc = a.split ? c - 1 : c;  // the chunk whose gradients follow
    if (!a.split) __syncthreads();  // its gamma rows
    if (gc >= 0 && grad_warp >= 0 && grad_warp < a.grad_warps) {
      const float* gbuf =
          sm.gbuf + (size_t)(a.split ? gc & 1 : 0) * a.chunk * S;
      float* wl = sm.wl + (size_t)grad_warp * a.L;
      const int f0 = gc * a.chunk, f1 = min(f0 + a.chunk, n_frames);
      for (int f = f0 + grad_warp; f < f1; f += a.grad_warps) {
        const size_t row_bs = (size_t)(top - f) * a.B + b;
        grad_frame(a, lab, gbuf + (size_t)(f - f0) * S, wl, sm.link,
                   a.grad + row_bs * C, sl, ll_len, ll, gb);
      }
    }
  }
}

typedef void (*Kernel)(CtcArgs);

// Positions a DP thread owns for S.
int positions_per_thread(int S) {
  if (S <= 512) return 1;
  if (S <= 2 * 512) return 2;
  for (int p = 4; p <= 32; p *= 2)
    if (S <= p * kMaxThreads) return p;
  return 0;
}

template <bool FWD>
Kernel kernel_for(int p) {
#define CTC_K(P_) (FWD ? ctc_fwd_kernel<P_> : ctc_bwd_kernel<P_>)
  switch (p) {
    case 1: return CTC_K(1);
    case 2: return CTC_K(2);
    case 4: return CTC_K(4);
    case 8: return CTC_K(8);
    case 16: return CTC_K(16);
    case 32: return CTC_K(32);
  }
#undef CTC_K
  return nullptr;
}

// Choose the branch, the threads, the chunk and the staging for one call and
// launch.  *branch: 0 staged, 1 unstaged.
int launch(CtcArgs& a, bool backward, void* stream, int* branch) {
  const int p = positions_per_thread(a.S);
  if (p == 0) return (int)cudaErrorInvalidValue;
  a.dp_threads = ((a.S + p - 1) / p + 31) / 32 * 32;
  const int width = backward ? a.C + a.S : a.C;
  const int max_chunk = a.T < kMaxChunk ? a.T : kMaxChunk;
  size_t floats = 0;
  bool found = false;
  // the backward's gradient warps: kGradWarps of their own where the CTA
  // has room for them and their second chunk of gamma rows, else the DP
  // warps after each chunk; then staged first, the longest chunk and the
  // most gradient warps that fit
  for (int split = backward && a.dp_threads + 32 * kGradWarps <= kMaxThreads;
       split >= 0 && !found; --split) {
    a.split = split;
    for (int staged = 1; staged >= 0 && !found; --staged) {
      for (int chunk = max_chunk; chunk >= 1 && !found; --chunk) {
        if (staged && (size_t)kStages * chunk * width * sizeof(float) >
                          (size_t)kRingBytes)
          continue;
        const int most = !backward ? 0
                         : split   ? kGradWarps
                                   : (a.dp_threads / 32 < chunk
                                          ? a.dp_threads / 32
                                          : chunk);
        for (int gw = most; gw >= (backward ? 1 : 0) && !found; --gw) {
          a.staged = staged, a.chunk = chunk, a.grad_warps = gw;
          floats = smem_floats(a, width, backward, nullptr, nullptr);
          found = floats * sizeof(float) <= (size_t)kSmemMax;
        }
      }
    }
  }
  if (!found) return (int)cudaErrorInvalidValue;
  const int nt = a.dp_threads + (a.split ? 32 * a.grad_warps : 0);
  Kernel kernel = backward ? kernel_for<false>(p) : kernel_for<true>(p);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  *branch = a.staged ? 0 : 1;
  kernel<<<a.B, nt, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// log_probs (T, B, C) fp32; labels (B, L) int32; in_len, lab_len (B,)
// int32; out neg_ll (B,) fp32 and, unless null, alphas (T, B, 2L + 1) fp32.
// *branch: 0 staged, 1 unstaged.  Returns a cudaError_t; 0 means
// launched.
int ctc_fwd(const void* log_probs, const void* labels, const void* in_len,
            const void* lab_len, void* neg_ll, void* alphas, int T, int B,
            int C, int L, int blank, void* stream, int* branch) {
  CtcArgs a = {};
  a.lp = static_cast<const float*>(log_probs);
  a.labels = static_cast<const int*>(labels);
  a.in_len = static_cast<const int*>(in_len);
  a.lab_len = static_cast<const int*>(lab_len);
  a.neg_ll = static_cast<float*>(neg_ll);
  a.alphas = static_cast<float*>(alphas);
  a.T = T, a.B = B, a.C = C, a.L = L, a.S = 2 * L + 1, a.blank = blank;
  return launch(a, false, stream, branch);
}

// As ctc_fwd's inputs, with alphas (T, B, S) from it, neg_ll (B,) and the
// upstream gradient g (B,) fp32; out grad (T, B, C) fp32, every entry, and,
// unless null, betas (T, B, S) fp32.
int ctc_bwd(const void* log_probs, const void* labels, const void* in_len,
            const void* lab_len, const void* alphas, const void* neg_ll,
            const void* g, void* grad, void* betas, int T, int B, int C,
            int L, int blank, void* stream, int* branch) {
  CtcArgs a = {};
  a.lp = static_cast<const float*>(log_probs);
  a.labels = static_cast<const int*>(labels);
  a.in_len = static_cast<const int*>(in_len);
  a.lab_len = static_cast<const int*>(lab_len);
  a.alphas_in = static_cast<const float*>(alphas);
  a.neg_ll_in = static_cast<const float*>(neg_ll);
  a.g = static_cast<const float*>(g);
  a.grad = static_cast<float*>(grad);
  a.betas = static_cast<float*>(betas);
  a.T = T, a.B = B, a.C = C, a.L = L, a.S = 2 * L + 1, a.blank = blank;
  return launch(a, true, stream, branch);
}

const char* ctc_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
