// The CNN front-end's conv epilogue for Hopper (sm_90a): the conv bias,
// BatchNorm2d over the channel axis, the activation and the time tail's
// mask of models/cnn.py, in one pass over the plane each way.
//
// It replaces no TPU kernel: the JAX package leaves this chain to XLA,
// which fuses it.  Eager PyTorch ran it as ~80 memory-bound passes over
// fp32 copies of the plane (the bias add, the cast to fp32, the masked
// sums of x and x * x, three broadcast passes for the normalisation, the
// cast back, the activation, the tail mask, and their reverses in the
// backward): ~190 bytes moved an element.  These kernels move ~16.
//
// Planes are NCHW (B, C, T, F), bf16 or fp32 ("T" below is that type),
// contiguous and 16-byte aligned.  Per channel c, with rounding to T where
// the plain twin (ops/conv_epilogue.py:conv_epilogue_plain) rounds:
//   xb   = T(conv + T(bias))
//   s1   = sum xb, s2 = sum xb * xb over the statistics mask (t < tv and
//          the row is real), n = F * #(b, t) in it        [stats]
//   y    = act(T((xb - mean) * k + beta)) * [t < tv]       [apply]
// where k = rsqrt(var + eps) * scale; mean, var and the running buffers
// are the caller's torch ops on (C,) vectors, between [stats] and [apply].
// The backward, with dy the gradient of y and dz = act'(.) ? dy * [t < tv]
// : 0 (relu passes where its output is > 0, clamp(0, 20) where 0 <= z <=
// 20, as autograd):
//   dbeta = sum dz, dk = sum dz * (xb - mean), dmean = -sum dz * k   [grad sums]
//   d(conv) = T(dz * k + g2 * xb + g2 * xb + g1), g1, g2 = ds1, ds2 on the
//          statistics mask and 0 off it; dbias = T(sum d(conv))      [grad apply]
// (ds1, ds2 are the gradients of s1, s2, from the (C,) chain; 0 in eval).
// Each elementwise step is a separately rounded fp32 operation
// (__fadd_rn, __fmul_rn: no contraction), in the twin's order.
//
// What bounds it: bytes.  Each pass streams the plane (2 or 4 bytes an
// element) at a handful of operations an element.  Forward: the stats
// read only the rows under the statistics mask, the apply reads the plane
// and writes y; backward: the sums read dy and the plane, the apply reads
// both again and writes d(conv).  At the flagship's B=128, T=392 the first
// conv's plane is 196 M elements: ~1.6 GB a step both ways in bf16, ~0.5 ms
// at 3.35 TB/s.
//
// Design: one block walks a run of whole time rows of one (b, c) slice,
// so its channel's operands sit in registers and its sums are one
// channel's; 16-byte loads and stores over the flat plane (a vector that
// straddles the run's edge is loaded whole and stored element by element).
// Per-channel sums are per-block partials in device memory, summed per
// channel by cnn_bn_sum_kernel in a fixed order: no float atomics, so two
// calls and two replays give equal bits.  tv is read from its 0-d device
// tensor, never on the host; nothing is allocated here and nothing
// synchronises: the launches are graph safe.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8192;  // elements a block walks, about

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int V = 4;
  __device__ static float round(float v) { return v; }
  __device__ static void load(const float* p, int64_t e0, int64_t n,
                              float* x) {
    if (e0 + V <= n) {
      const float4 q = *reinterpret_cast<const float4*>(p + e0);
      x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
    } else {
      for (int j = 0; j < V; ++j) x[j] = e0 + j < n ? p[e0 + j] : 0.f;
    }
  }
  // x[j] to p[e0 + j] for e0 + j in [g0, g1)
  __device__ static void store(float* p, int64_t e0, int64_t g0, int64_t g1,
                               const float* x) {
    if (e0 >= g0 && e0 + V <= g1) {
      *reinterpret_cast<float4*>(p + e0) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      for (int j = 0; j < V; ++j)
        if (e0 + j >= g0 && e0 + j < g1) p[e0 + j] = x[j];
    }
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void load(const __nv_bfloat16* p, int64_t e0, int64_t n,
                              float* x) {
    if (e0 + V <= n) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + e0);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
      for (int i = 0; i < V / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        x[2 * i] = f.x, x[2 * i + 1] = f.y;
      }
    } else {
      for (int j = 0; j < V; ++j)
        x[j] = e0 + j < n ? __bfloat162float(p[e0 + j]) : 0.f;
    }
  }
  __device__ static void store(__nv_bfloat16* p, int64_t e0, int64_t g0,
                               int64_t g1, const float* x) {
    if (e0 >= g0 && e0 + V <= g1) {
      uint4 q;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
      for (int i = 0; i < V / 2; ++i)
        h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      *reinterpret_cast<uint4*>(p + e0) = q;
    } else {
      for (int j = 0; j < V; ++j)
        if (e0 + j >= g0 && e0 + j < g1) p[e0 + j] = __float2bfloat16_rn(x[j]);
    }
  }
};

enum { kRelu = 0, kHardtanh = 1 };

// torch.relu and torch.clamp(z, 0, 20): NaN passes through
template <int kAct>
__device__ __forceinline__ float act(float z) {
  if (kAct == kRelu) return z < 0.f ? 0.f : z;
  return z < 0.f ? 0.f : (z > 20.f ? 20.f : z);
}

// autograd's gate: relu's threshold_backward on its output (passes where
// the output is not <= 0), clamp_backward on its input (0 <= z <= 20)
template <int kAct>
__device__ __forceinline__ bool passes(float zb) {
  if (kAct == kRelu) return !(act<kRelu>(zb) <= 0.f);
  return zb >= 0.f && zb <= 20.f;
}

struct EpiArgs {
  const void* conv;  // (B, C, T, F) raw conv output
  const void* dy;    // (B, C, T, F) gradient of y (backward)
  void* out;         // y, or d(conv)
  const float* bias;  // (C,) conv bias, fp32 (rounded to T here)
  const float* mean;  // (C,)
  const float* k;     // (C,) rsqrt(var + eps) * scale
  const float* beta;  // (C,)
  const float* ds1;   // (C,) or null (eval)
  const float* ds2;   // (C,) or null (eval)
  const int* tv;      // 0-d frames below the tail, or null: T
  const unsigned char* rows;  // (B,) 0/1 real rows, or null: all
  float* partial;     // (nk, C, P) per-block sums, P = B * nchunk
  int B, C, T, F, R, nchunk;
};

// one block's run: slice (b, c), time rows [t0, t0 + R), local elements
// [lo, hi) of the slice that starts at flat element `base`
struct Run {
  int b, c, p, lo, hi;
  int64_t base;
};

__device__ __forceinline__ Run run_of(const EpiArgs& a) {
  Run r;
  const int s = blockIdx.x, chunk = blockIdx.y;
  r.b = s / a.C;
  r.c = s - r.b * a.C;
  r.p = r.b * a.nchunk + chunk;
  r.base = static_cast<int64_t>(s) * a.T * a.F;
  const int t0 = chunk * a.R;
  r.lo = t0 * a.F;
  r.hi = min(a.T, t0 + a.R) * a.F;
  return r;
}

// frames below the tail mask
__device__ __forceinline__ int tail_of(const EpiArgs& a) {
  return a.tv ? min(*a.tv, a.T) : a.T;
}

// frames of row b under the statistics mask
__device__ __forceinline__ int stats_end(const EpiArgs& a, int b) {
  return (a.rows && !a.rows[b]) ? 0 : tail_of(a);
}

// Walk the 16-byte vectors that cover local elements [lo, hi) of the run's
// slice, the block's threads one vector each in turn; fn(e0, t, in) gets
// the vector's first flat element, each element's time row and whether it
// lies in [lo, hi).
template <typename T, typename Fn>
__device__ __forceinline__ void walk(const EpiArgs& a, const Run& r, int lo,
                                     int hi, Fn&& fn) {
  constexpr int V = Elem<T>::V;
  const int64_t g0 = r.base + lo, g1 = r.base + hi;
  for (int64_t e0 = (g0 / V) * V + static_cast<int64_t>(threadIdx.x) * V;
       e0 < g1; e0 += static_cast<int64_t>(blockDim.x) * V) {
    int l = static_cast<int>(e0 - r.base);
    int t = 0, f = 0;
    if (l > 0) {
      t = l / a.F;
      f = l - t * a.F;
    }
    int tj[V];
    bool in[V];
#pragma unroll
    for (int j = 0; j < V; ++j, ++l) {
      tj[j] = t;
      in[j] = l >= lo && l < hi;
      if (l >= 0 && ++f == a.F) f = 0, ++t;
    }
    fn(e0, tj, in);
  }
}

// the block's N sums into partial[(i * C + c) * P + p], in a fixed order
template <int N>
__device__ __forceinline__ void store_partials(float (&v)[N], const EpiArgs& a,
                                               const Run& r) {
  __shared__ float red[N][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < N; ++i) {
    float s = v[i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[i][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[threadIdx.x][w];
    const int64_t P = static_cast<int64_t>(a.B) * a.nchunk;
    a.partial[(static_cast<int64_t>(threadIdx.x) * a.C + r.c) * P + r.p] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cnn_bn_stats_kernel(EpiArgs a) {
  const Run r = run_of(a);
  const int hi = min(r.hi, stats_end(a, r.b) * a.F);
  const int64_t n = static_cast<int64_t>(a.B) * a.C * a.T * a.F;
  const T* conv = static_cast<const T*>(a.conv);
  const float bb = Elem<T>::round(a.bias[r.c]);
  float acc[2] = {0.f, 0.f};
  if (r.lo < hi) {
    walk<T>(a, r, r.lo, hi, [&](int64_t e0, const int*, const bool* in) {
      float x[Elem<T>::V];
      Elem<T>::load(conv, e0, n, x);
#pragma unroll
      for (int j = 0; j < Elem<T>::V; ++j) {
        if (!in[j]) continue;
        const float xb = Elem<T>::round(__fadd_rn(x[j], bb));
        acc[0] += xb;
        acc[1] += __fmul_rn(xb, xb);
      }
    });
  }
  store_partials<2>(acc, a, r);
}

// one channel's operands and the forward's steps from a raw conv element
template <typename T>
struct Norm {
  float bb, mean, k, beta;
  __device__ Norm(const EpiArgs& a, int c)
      : bb(Elem<T>::round(a.bias[c])), mean(a.mean[c]), k(a.k[c]),
        beta(a.beta[c]) {}
  __device__ float xb(float x) const { return Elem<T>::round(__fadd_rn(x, bb)); }
  __device__ float u(float xb) const { return __fsub_rn(xb, mean); }
  __device__ float zb(float u) const {
    return Elem<T>::round(__fadd_rn(__fmul_rn(u, k), beta));
  }
};

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads) cnn_bn_apply_kernel(EpiArgs a) {
  const Run r = run_of(a);
  const int tail = tail_of(a);
  const int64_t n = static_cast<int64_t>(a.B) * a.C * a.T * a.F;
  const T* conv = static_cast<const T*>(a.conv);
  T* out = static_cast<T*>(a.out);
  const Norm<T> nm(a, r.c);
  walk<T>(a, r, r.lo, r.hi, [&](int64_t e0, const int* tj, const bool*) {
    float x[Elem<T>::V];
    Elem<T>::load(conv, e0, n, x);
#pragma unroll
    for (int j = 0; j < Elem<T>::V; ++j) {
      const float z = act<kAct>(nm.zb(nm.u(nm.xb(x[j]))));
      x[j] = __fmul_rn(z, tj[j] < tail ? 1.f : 0.f);
    }
    Elem<T>::store(out, e0, r.base + r.lo, r.base + r.hi, x);
  });
}

// xb (in place of x), u and dz of each element of a vector: dz is dy
// under the tail mask and the activation's gate
template <typename T, int kAct>
__device__ __forceinline__ void grad_z(const Norm<T>& nm, int tail,
                                       const int* tj, float* x,
                                       const float* dy, float* u, float* dz) {
#pragma unroll
  for (int j = 0; j < Elem<T>::V; ++j) {
    x[j] = nm.xb(x[j]);
    u[j] = nm.u(x[j]);
    const float g = __fmul_rn(dy[j], tj[j] < tail ? 1.f : 0.f);
    dz[j] = passes<kAct>(nm.zb(u[j])) ? g : 0.f;
  }
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads) cnn_bn_grad_sums_kernel(
    EpiArgs a) {
  const Run r = run_of(a);
  const int tail = tail_of(a);
  const int64_t n = static_cast<int64_t>(a.B) * a.C * a.T * a.F;
  const T* conv = static_cast<const T*>(a.conv);
  const T* dyp = static_cast<const T*>(a.dy);
  const Norm<T> nm(a, r.c);
  float acc[3] = {0.f, 0.f, 0.f};
  walk<T>(a, r, r.lo, r.hi, [&](int64_t e0, const int* tj, const bool* in) {
    constexpr int V = Elem<T>::V;
    float x[V], dy[V], u[V], dz[V];
    Elem<T>::load(conv, e0, n, x);
    Elem<T>::load(dyp, e0, n, dy);
    grad_z<T, kAct>(nm, tail, tj, x, dy, u, dz);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (!in[j]) continue;
      acc[0] += dz[j];
      acc[1] += __fmul_rn(dz[j], u[j]);
      acc[2] += __fmul_rn(dz[j], nm.k);
    }
  });
  store_partials<3>(acc, a, r);
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads) cnn_bn_grad_apply_kernel(
    EpiArgs a) {
  const Run r = run_of(a);
  const int tail = tail_of(a);
  const int send = stats_end(a, r.b);
  const int64_t n = static_cast<int64_t>(a.B) * a.C * a.T * a.F;
  const T* conv = static_cast<const T*>(a.conv);
  const T* dyp = static_cast<const T*>(a.dy);
  T* out = static_cast<T*>(a.out);
  const Norm<T> nm(a, r.c);
  const float ds1 = a.ds1 ? a.ds1[r.c] : 0.f;
  const float ds2 = a.ds2 ? a.ds2[r.c] : 0.f;
  float acc[1] = {0.f};
  walk<T>(a, r, r.lo, r.hi, [&](int64_t e0, const int* tj, const bool* in) {
    constexpr int V = Elem<T>::V;
    float x[V], dy[V], u[V], dz[V];
    Elem<T>::load(conv, e0, n, x);
    Elem<T>::load(dyp, e0, n, dy);
    grad_z<T, kAct>(nm, tail, tj, x, dy, u, dz);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool st = tj[j] < send;
      const float g1 = st ? ds1 : 0.f, g2 = st ? ds2 : 0.f;
      // autograd's order: the normalisation's term, then x * x's two, then
      // the sum's
      const float gx = __fmul_rn(g2, x[j]);
      float d = __fadd_rn(__fmul_rn(dz[j], nm.k), gx);
      d = __fadd_rn(__fadd_rn(d, gx), g1);
      x[j] = Elem<T>::round(d);
      if (in[j]) acc[0] += x[j];
    }
    Elem<T>::store(out, e0, r.base + r.lo, r.base + r.hi, x);
  });
  store_partials<1>(acc, a, r);
}

// out[i * C + c] = the sum of partial[(i * C + c) * P + 0 .. P), negated
// where bit i of `neg` is set, rounded to bf16 where `round_bf16`; block
// (0, 0) also writes *count = F * #(b, t) under the statistics mask
__global__ void __launch_bounds__(kThreads) cnn_bn_sum_kernel(
    EpiArgs a, float* out, unsigned neg, int round_bf16, float* count) {
  const int c = blockIdx.x, i = blockIdx.y;
  const int64_t P = static_cast<int64_t>(a.B) * a.nchunk;
  const float* src = a.partial + (static_cast<int64_t>(i) * a.C + c) * P;
  float s = 0.f;
  for (int64_t p = threadIdx.x; p < P; p += blockDim.x) s += src[p];
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    if (neg >> i & 1u) t = -t;
    if (round_bf16) t = Elem<__nv_bfloat16>::round(t);
    out[i * a.C + c] = t;
    if (count && c == 0 && i == 0) {
      int frames = 0;
      for (int b = 0; b < a.B; ++b) frames += max(stats_end(a, b), 0);
      *count = __fmul_rn(static_cast<float>(frames), static_cast<float>(a.F));
    }
  }
}

int check_shape(int B, int C, int T, int F) {
  if (B < 1 || C < 1 || T < 1 || F < 1) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(T) * F + 16 > INT32_MAX) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(B) * C > INT32_MAX) return cudaErrorInvalidValue;
  return cudaSuccess;
}

EpiArgs args_of(int B, int C, int T, int F) {
  EpiArgs a = {};
  a.B = B, a.C = C, a.T = T, a.F = F;
  a.R = max(1, kChunk / F);
  a.nchunk = (T + a.R - 1) / a.R;
  return a;
}

dim3 grid_of(const EpiArgs& a) {
  return dim3(static_cast<unsigned>(a.B * a.C), static_cast<unsigned>(a.nchunk));
}

template <template <typename, int> class K>
int launch_typed(const EpiArgs& a, int bf16, int act_id, cudaStream_t st) {
  if (a.nchunk > 65535) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(a);
  if (bf16 && act_id == kRelu)
    K<__nv_bfloat16, kRelu>::launch(grid, a, st);
  else if (bf16 && act_id == kHardtanh)
    K<__nv_bfloat16, kHardtanh>::launch(grid, a, st);
  else if (!bf16 && act_id == kRelu)
    K<float, kRelu>::launch(grid, a, st);
  else if (!bf16 && act_id == kHardtanh)
    K<float, kHardtanh>::launch(grid, a, st);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T, int kAct>
struct Apply {
  static void launch(dim3 g, const EpiArgs& a, cudaStream_t st) {
    cnn_bn_apply_kernel<T, kAct><<<g, kThreads, 0, st>>>(a);
  }
};
template <typename T, int kAct>
struct GradSums {
  static void launch(dim3 g, const EpiArgs& a, cudaStream_t st) {
    cnn_bn_grad_sums_kernel<T, kAct><<<g, kThreads, 0, st>>>(a);
  }
};
template <typename T, int kAct>
struct GradApply {
  static void launch(dim3 g, const EpiArgs& a, cudaStream_t st) {
    cnn_bn_grad_apply_kernel<T, kAct><<<g, kThreads, 0, st>>>(a);
  }
};

int sum_partials(const EpiArgs& a, int nk, float* out, unsigned neg,
                 int round_bf16, float* count, cudaStream_t st) {
  cnn_bn_sum_kernel<<<dim3(a.C, nk), kThreads, 0, st>>>(a, out, neg,
                                                        round_bf16, count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-block partial sums a channel: P = B * nchunk (the partial buffers
// are (nk, C, P) fp32).
int cnn_epi_parts(int B, int T, int F) {
  const EpiArgs a = args_of(B, 1, T, F);
  return B * a.nchunk;
}

// Train-mode statistics: sums (2, C) fp32 = s1, s2 over the statistics mask
// and *count = n (fp32, 0-d); partial (2, C, P) fp32 scratch.  bias (C,)
// fp32; tv 0-d int32 or null; rows (B,) bool or null.  Returns a
// cudaError_t; 0 means launched.
int cnn_epi_stats(const void* conv, const float* bias, const int* tv,
                  const unsigned char* rows, float* partial, float* sums,
                  float* count, int B, int C, int T, int F, int bf16,
                  void* stream) {
  if (int e = check_shape(B, C, T, F)) return e;
  EpiArgs a = args_of(B, C, T, F);
  a.conv = conv, a.bias = bias, a.tv = tv, a.rows = rows, a.partial = partial;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.nchunk > 65535) return cudaErrorInvalidValue;
  if (bf16)
    cnn_bn_stats_kernel<__nv_bfloat16><<<grid_of(a), kThreads, 0, st>>>(a);
  else
    cnn_bn_stats_kernel<float><<<grid_of(a), kThreads, 0, st>>>(a);
  if (int e = cudaGetLastError()) return e;
  return sum_partials(a, 2, sums, 0u, 0, count, st);
}

// y (B, C, T, F) in the plane's type from the raw conv plane and the (C,)
// fp32 bias, mean, k and beta; act 0 relu, 1 clamp(0, 20).
int cnn_epi_apply(const void* conv, const float* bias, const float* mean,
                  const float* k, const float* beta, const int* tv, void* out,
                  int B, int C, int T, int F, int bf16, int act_id,
                  void* stream) {
  if (int e = check_shape(B, C, T, F)) return e;
  EpiArgs a = args_of(B, C, T, F);
  a.conv = conv, a.bias = bias, a.mean = mean, a.k = k, a.beta = beta;
  a.tv = tv, a.out = out;
  return launch_typed<Apply>(a, bf16, act_id, static_cast<cudaStream_t>(stream));
}

// Backward sums: sums (3, C) fp32 = dbeta, dk, dmean; partial (3, C, P).
int cnn_epi_grad_sums(const void* conv, const void* dy, const float* bias,
                      const float* mean, const float* k, const float* beta,
                      const int* tv, float* partial, float* sums, int B, int C,
                      int T, int F, int bf16, int act_id, void* stream) {
  if (int e = check_shape(B, C, T, F)) return e;
  EpiArgs a = args_of(B, C, T, F);
  a.conv = conv, a.dy = dy, a.bias = bias, a.mean = mean, a.k = k;
  a.beta = beta, a.tv = tv, a.partial = partial;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int e = launch_typed<GradSums>(a, bf16, act_id, st)) return e;
  return sum_partials(a, 3, sums, 4u, 0, nullptr, st);
}

// Backward apply: dconv (B, C, T, F) in the plane's type and dbias (C,)
// fp32 (the sum of dconv, rounded to the plane's type); ds1, ds2 (C,) or
// both null (eval); partial (1, C, P).
int cnn_epi_grad_apply(const void* conv, const void* dy, const float* bias,
                       const float* mean, const float* k, const float* beta,
                       const float* ds1, const float* ds2, const int* tv,
                       const unsigned char* rows, void* dconv, float* partial,
                       float* dbias, int B, int C, int T, int F, int bf16,
                       int act_id, void* stream) {
  if (int e = check_shape(B, C, T, F)) return e;
  EpiArgs a = args_of(B, C, T, F);
  a.conv = conv, a.dy = dy, a.bias = bias, a.mean = mean, a.k = k;
  a.beta = beta, a.ds1 = ds1, a.ds2 = ds2, a.tv = tv, a.rows = rows;
  a.out = dconv, a.partial = partial;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int e = launch_typed<GradApply>(a, bf16, act_id, st)) return e;
  return sum_partials(a, 1, dbias, 0u, bf16, nullptr, st);
}

const char* cnn_epi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
