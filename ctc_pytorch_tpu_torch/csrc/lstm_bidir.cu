// Bidirectional LSTM recurrence for eval and decode, one cooperative launch
// per layer, for Hopper (sm_90a).
//
// Replaces ctc_pytorch_tpu/ops/lstm_pallas_v2.py:lstm_bidir_pallas_v2 (the
// Pallas kernel _make_kernel at :61, cell _cell2 at :42).  Same function:
//   gx (T, B, 8H) in the stream type S (fp32 or bf16), lanes [0,4H) are the
//   forward direction's gate inputs, [4H,8H) the backward direction's;
//   w_hh (2, H, 4H) fp32, gate order i, f, g, o; h0 = c0 = 0.
//   Direction 0 walks t = 0..T-1, direction 1 walks t = T-1..0, and
//   ys[t, :, d*H:(d+1)*H] = h_d(t) rounded to S.  Gate math, h and c are fp32.
//
// What bounds it: the T steps are a serial chain, and each step is a small
// fp32 product (B, H) @ (H, 4H) per direction on CUDA cores.  At the decode
// bench shape (T=80, B=128, H=384) the product is 24.2 GFLOP per layer,
// about 0.36 ms at the H100's 67 TFLOP/s fp32, while the bytes (gx, ys,
// w_hh: ~83 MB) take ~25 us at 3.35 TB/s: operations bound it, and the 80
// grid-wide barriers and the L2 round trips inside each step add a latency
// floor on top.
//
// Design: one persistent cooperative grid.  CTA (d, g) owns U hidden units
// of direction d and keeps the matching 4*U columns of w_hh[d] in shared
// memory for the whole run, so the weights are read from device memory
// once.  Each thread owns one hidden unit and kRows batch rows and computes
// all four gates for them, so the cell update needs no exchange inside the
// CTA; c stays in a global scratch that only its owning thread touches.
// h_{t-1} lives transposed, (H, ldh), in a global double buffer (it stays
// in L2).  Each step every CTA streams it through shared memory in k-tiles
// with cp.async (L2 only, so it sees the other SMs' writes), two tiles in
// flight so one tile's copy overlaps the previous tile's products, then
// writes its slice of h_t and ys, and the grid meets at grid.sync().
// With U = 8 a CTA needs 128*H + 64 KB of shared memory, so above H = 392
// one CTA fits per SM, and the 2*ceil(H/8) CTAs are co-resident only while
// H <= 4 * SMs (528 on a 132-SM H100).  Past that a co-resident grid of one
// CTA per SM strides over the (d, g) items and reads w_hh from L2 instead,
// so any H runs.
// Tensor cores (wgmma), TMA and cluster-resident weights are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 8;             // hidden units per CTA (U)
constexpr int kRows = 4;              // batch rows per thread
constexpr int kRowTile = 32 * kRows;  // rows per pass of a CTA (32 row groups)
constexpr int kTileK = 64;            // k-rows of h per shared-memory tile
constexpr int kTileFloats = kTileK * kRowTile;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// 16-byte global -> shared copy that bypasses L1; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [k0, k0 + kTileK) x columns [r0, r0 + kRowTile) of h (H, ldh)
// into a tile; ldh % 4 == 0 and columns >= ldh read as zeros.
__device__ __forceinline__ void stage(float* tile, const float* h, int k0,
                                      int r0, int H, int ldh, int tid) {
  constexpr int kThreads = 32 * kUnits;
  constexpr int kVecs = kTileFloats / 4;
#pragma unroll
  for (int i = 0; i < kVecs / kThreads; ++i) {
    const int v = tid + i * kThreads;
    const int k = k0 + v / (kRowTile / 4);
    const int b = r0 + 4 * (v % (kRowTile / 4));
    const bool ok = k < H && b < ldh;
    cp_async16(tile + 4 * v, ok ? h + (size_t)k * ldh + b : h, ok);
  }
  cp_async_commit();
}

// One time step of work item (d, u0): the gates of units
// [u0, u0 + kUnits) of direction d for every batch row.  w_s holds those
// units' weights when they are resident in shared memory; otherwise they
// come from w (L2).
template <typename S, bool kResident>
__device__ __forceinline__ void step_item(
    const S* __restrict__ gx, const float* __restrict__ w,
    const float4* w_s, S* __restrict__ ys, const float* h_prev,
    float* h_next, float* c, float* tiles, int t, int u0, int d, int B,
    int H, int ldh) {
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rq = tid / kUnits;  // row group, 0..31
  const int unit = u0 + u;
  const bool unit_ok = unit < H;
  const size_t h4 = 4 * (size_t)H;
  const int n_tiles = (H + kTileK - 1) / kTileK;
  // past-the-end units read a valid column and store nothing
  const float* w_col = w + min(unit, H - 1);
  const S* gx_t = gx + (size_t)t * B * 2 * h4 + d * h4;
  S* ys_t = ys + (size_t)t * B * 2 * H + (size_t)d * H;

  for (int r0 = 0; r0 < B; r0 += kRowTile) {
    stage(tiles, h_prev, 0, r0, H, ldh, tid);
    float acc[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      const bool ok = unit_ok && b < B;
      const S* g = gx_t + (size_t)b * 2 * h4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = ok ? load_f(g + q * H) : 0.f;
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
      if (kt + 1 < n_tiles) {
        stage(tiles + ((kt + 1) & 1) * kTileFloats, h_prev, (kt + 1) * kTileK,
              r0, H, ldh, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile kt (and, first, w_s) visible to all
      const float* tile = tiles + (kt & 1) * kTileFloats;
      const int k0 = kt * kTileK;
      // row groups wholly past B (small batches) skip the products
      const int kn = r0 + rq * kRows < B ? min(kTileK, H - k0) : 0;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float4 wv;
        if constexpr (kResident) {
          wv = w_s[(size_t)(k0 + kk) * kUnits + u];
        } else {
          const float* row = w_col + (size_t)(k0 + kk) * h4;
          wv = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
        }
        const float4 hv =
            *reinterpret_cast<const float4*>(tile + kk * kRowTile + rq * kRows);
        const float hr[kRows] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          acc[j][0] = fmaf(hr[j], wv.x, acc[j][0]);
          acc[j][1] = fmaf(hr[j], wv.y, acc[j][1]);
          acc[j][2] = fmaf(hr[j], wv.z, acc[j][2]);
          acc[j][3] = fmaf(hr[j], wv.w, acc[j][3]);
        }
      }
      __syncthreads();  // tile kt consumed before its buffer is refilled
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      if (!unit_ok || b >= B) continue;
      const float ig = sigmoid_f(acc[j][0]);
      const float fg = sigmoid_f(acc[j][1]);
      const float gg = tanhf(acc[j][2]);
      const float og = sigmoid_f(acc[j][3]);
      float* cp = c + (size_t)b * H + unit;
      const float cn = fg * *cp + ig * gg;
      *cp = cn;
      const float hn = og * tanhf(cn);
      h_next[(size_t)unit * ldh + b] = hn;
      store_f(ys_t + (size_t)b * 2 * H + unit, hn);
    }
  }
}

// Work item i = (direction i / groups, units from (i % groups) * kUnits).
// With kResident the grid has one CTA per item and each CTA keeps its item's
// weights in shared memory for the whole run; otherwise (large H) a smaller
// co-resident grid strides over the items and reads the weights from L2.
template <typename S, bool kResident>
__global__ void __launch_bounds__(32 * kUnits)
    lstm_bidir_kernel(const S* __restrict__ gx, const float* __restrict__ w_hh,
                      S* __restrict__ ys, float* hbuf, float* cbuf, int T,
                      int B, int H, int ldh) {
  extern __shared__ float4 smem[];
  float4* w_s = smem;  // kResident: [H][kUnits], (i, f, g, o) per unit
  float* tiles = reinterpret_cast<float*>(
      smem + (kResident ? (size_t)H * kUnits : 0));  // [2][kTileFloats]

  const int groups = (H + kUnits - 1) / kUnits;
  const int items = 2 * groups;
  const size_t h4 = 4 * (size_t)H;

  if constexpr (kResident) {
    const int d = blockIdx.x / groups;
    const int u0 = (blockIdx.x % groups) * kUnits;
    const float* w = w_hh + (size_t)d * H * h4;
    for (int idx = threadIdx.x; idx < H * kUnits; idx += 32 * kUnits) {
      const int k = idx / kUnits, un = u0 + idx % kUnits;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (un < H) {
        const float* row = w + (size_t)k * h4 + un;
        v = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
      }
      w_s[idx] = v;
    }
  }

  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < T; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int d = item / groups;
      const int u0 = (item % groups) * kUnits;
      float* hT = hbuf + (size_t)d * 2 * H * ldh;  // [2][H][ldh], zeroed
      step_item<S, kResident>(
          gx, w_hh + (size_t)d * H * h4, w_s, ys,
          hT + (size_t)(s & 1) * H * ldh, hT + (size_t)((s + 1) & 1) * H * ldh,
          cbuf + (size_t)d * B * H,  // [B][H], zeroed by the caller
          tiles, d == 0 ? s : T - 1 - s, u0, d, B, H, ldh);
    }
    grid.sync();
  }
}

size_t smem_bytes(int H, bool resident) {
  return (resident ? (size_t)H * kUnits * sizeof(float4) : 0) +
         2 * (size_t)kTileFloats * sizeof(float);
}

// Resident: one CTA per work item, and only when that grid can be
// co-resident (a cooperative launch needs every CTA resident at once); sets
// *fits = 0 and launches nothing otherwise.  Not resident: as many CTAs as
// can be co-resident, at most one per item.
template <typename S, bool kResident>
cudaError_t try_launch(const void* gx, const void* w_hh, void* ys, void* hbuf,
                       void* cbuf, int T, int B, int H, int ldh, int sms,
                       cudaStream_t stream, int* fits) {
  auto kernel = lstm_bidir_kernel<S, kResident>;
  *fits = 0;
  const size_t smem = smem_bytes(H, kResident);
  if (smem > 232448) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * kUnits, smem);
  if (err != cudaSuccess) return err;
  const int items = 2 * ((H + kUnits - 1) / kUnits);
  const int capacity = per_sm * sms;
  if (capacity < 1 || (kResident && items > capacity)) return cudaSuccess;
  const int grid = items < capacity ? items : capacity;
  *fits = 1;
  const S* gx_p = static_cast<const S*>(gx);
  const float* w_p = static_cast<const float*>(w_hh);
  S* ys_p = static_cast<S*>(ys);
  float* h_p = static_cast<float*>(hbuf);
  float* c_p = static_cast<float*>(cbuf);
  void* args[] = {&gx_p, &w_p, &ys_p, &h_p, &c_p, &T, &B, &H, &ldh};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(32 * kUnits), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Resident weights while the grid fits (H <= 4 * SMs, see the header);
// past that the weights stay in L2.
template <typename S>
cudaError_t launch(const void* gx, const void* w_hh, void* ys, void* hbuf,
                   void* cbuf, int T, int B, int H, int ldh,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, coop = 0, fits = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = try_launch<S, true>(gx, w_hh, ys, hbuf, cbuf, T, B, H, ldh, sms,
                            stream, &fits);
  if (err != cudaSuccess || fits) return err;
  err = try_launch<S, false>(gx, w_hh, ys, hbuf, cbuf, T, B, H, ldh, sms,
                             stream, &fits);
  if (err != cudaSuccess || fits) return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

extern "C" {

// gx (T, B, 8H) and ys (T, B, 2H) in the stream type (bf16 != 0: bfloat16,
// else float32); w_hh (2, H, 4H) fp32; hbuf (2, 2, H, ldh) with ldh >= B a
// multiple of 4, and cbuf (2, B, H), both fp32 zeros.  Returns a
// cudaError_t; 0 means launched.
int lstm_bidir_forward(const void* gx, const void* w_hh, void* ys, void* hbuf,
                       void* cbuf, int T, int B, int H, int ldh, int bf16,
                       void* stream) {
  if (ldh < B || ldh % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch<__nv_bfloat16>(gx, w_hh, ys, hbuf, cbuf, T, B, H, ldh,
                                      st);
  return (int)launch<float>(gx, w_hh, ys, hbuf, cbuf, T, B, H, ldh, st);
}

const char* lstm_bidir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
