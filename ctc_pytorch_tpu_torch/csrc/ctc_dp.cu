// CTC alpha and beta dynamic programs for Hopper (sm_90a).
//
// Replaces ctc_pytorch_tpu/ops/ctc_pallas.py: ctc_alpha_pallas (kernel
// _alpha_kernel) and ctc_beta_pallas (kernel _beta_kernel).  Same function,
// all fp32, log domain with NEG_INF = -1e30:
//   emit (T, B, S)   log p(t, z_s) gathered outside, S = 2L + 1
//   skip (B, S)      0 where the skip transition is allowed, else NEG_INF
//                    (into s for alpha, out of s for beta)
//   mask (B, S)      1 for s < 2 * label_len + 1, else 0
//   len (B,)         valid frames;  slen (B,) valid extended positions
//   alpha[0] = emit[0] at s <= 1 (masked); for t >= 1
//   alpha[t] = lse3(alpha[t-1, s], alpha[t-1, s-1], alpha[t-1, s-2] + skip)
//              + emit[t], masked, and frozen once t >= len;
//   beta walks t = T-1 .. 0 from an all-NEG_INF row with s+1, s+2, and takes
//   the terminal row (emit at s = slen-1, slen-2) at t == len-1; rows past
//   it are don't-care and the gradient masks them.
// lse3 pins a cell whose three inputs are all dead to exactly NEG_INF, so an
// utterance whose labels do not fit its frames gets a huge finite loss and
// zero gradients instead of inf/nan.
//
// What bounds it: neither bytes nor operations but the T serial frames.  The
// tables are small (two (80, 128, 97) fp32 tables are 7.9 MB, ~2.4 us at
// 3.35 TB/s) and a frame is a handful of fp32 operations per position.
//
// Design: one CTA per utterance, one thread per extended position (a loop
// over positions past 1024), the DP row double-buffered in shared memory
// with one __syncthreads() per frame; the neighbours s-1, s-2 (s+1, s+2) are
// plain shared-memory reads.  No exchange between CTAs, so a plain launch.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float m_safe = fmaxf(m, kNegInf / 2);
  const float s = expf(a - m_safe) + expf(b - m_safe) + expf(c - m_safe);
  return m <= kNegInf / 2 ? kNegInf : m_safe + logf(fmaxf(s, 1e-37f));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emit,
                                 const float* __restrict__ skip,
                                 const float* __restrict__ mask,
                                 const int* __restrict__ len,
                                 float* __restrict__ alphas, int T, int B,
                                 int S) {
  extern __shared__ float row[];  // [2][S]
  const int b = blockIdx.x;
  const int n = len[b];
  const float* skip_b = skip + (size_t)b * S;
  const float* mask_b = mask + (size_t)b * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float v = s <= 1 ? emit[(size_t)b * S + s] : kNegInf;
    v = mask_b[s] > 0.f ? v : kNegInf;
    row[s] = v;
    alphas[(size_t)b * S + s] = v;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = row + ((t - 1) & 1) * S;
    float* cur = row + (t & 1) * S;
    const size_t off = ((size_t)t * B + b) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float a = prev[s];
      const float p1 = s >= 1 ? prev[s - 1] : kNegInf;
      const float p2 = (s >= 2 ? prev[s - 2] : kNegInf) + skip_b[s];
      float v = lse3(a, p1, p2) + emit[off + s];
      v = mask_b[s] > 0.f ? v : kNegInf;
      v = t < n ? v : a;  // finished utterances keep their row
      cur[s] = v;
      alphas[off + s] = v;
    }
    __syncthreads();
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ emit,
                                const float* __restrict__ skip_out,
                                const float* __restrict__ mask,
                                const int* __restrict__ len,
                                const int* __restrict__ slen,
                                float* __restrict__ betas, int T, int B,
                                int S) {
  extern __shared__ float row[];  // [2][S]
  const int b = blockIdx.x;
  const int n = len[b];
  const int sl = slen[b];
  const float* skip_b = skip_out + (size_t)b * S;
  const float* mask_b = mask + (size_t)b * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) row[s] = kNegInf;
  __syncthreads();
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    const float* prev = row + (i & 1) * S;
    float* cur = row + ((i + 1) & 1) * S;
    const size_t off = ((size_t)t * B + b) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float e = emit[off + s];
      const float n1 = s + 1 < S ? prev[s + 1] : kNegInf;
      const float n2 = (s + 2 < S ? prev[s + 2] : kNegInf) + skip_b[s];
      float v = lse3(prev[s], n1, n2) + e;
      v = mask_b[s] > 0.f ? v : kNegInf;
      if (t == n - 1) v = (s == sl - 1 || s == sl - 2) ? e : kNegInf;
      cur[s] = v;
      betas[off + s] = v;
    }
    __syncthreads();
  }
}

int block_threads(int S) {
  const int t = ((S + 31) / 32) * 32;
  return t > 1024 ? 1024 : t;
}

}  // namespace

extern "C" {

// emit, alphas (T, B, S), skip, mask (B, S) fp32; len (B,) int32.  Returns a
// cudaError_t; 0 means launched.
int ctc_alpha(const void* emit, const void* skip, const void* mask,
              const void* len, void* alphas, int T, int B, int S,
              void* stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_alpha_kernel<<<B, block_threads(S), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(skip),
      static_cast<const float*>(mask), static_cast<const int*>(len),
      static_cast<float*>(alphas), T, B, S);
  return (int)cudaGetLastError();
}

// As ctc_alpha, with skip the out-of-s mask and slen (B,) int32.
int ctc_beta(const void* emit, const void* skip_out, const void* mask,
             const void* len, const void* slen, void* betas, int T, int B,
             int S, void* stream) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ctc_beta_kernel<<<B, block_threads(S), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(skip_out),
      static_cast<const float*>(mask), static_cast<const int*>(len),
      static_cast<const int*>(slen), static_cast<float*>(betas), T, B, S);
  return (int)cudaGetLastError();
}

const char* ctc_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
