// Device code and launcher of the bidirectional LSTM forward recurrence,
// shared by the eval kernel (lstm_bidir.cu) and the training forward
// (lstm_bidir_train.cu).  kTrain = false is the eval kernel exactly;
// kTrain = true also writes the cell states cs (T, B, 2H) beside ys and,
// with bf16 streams, rounds each h to bf16 before it enters the next
// step's recurrent product, as the training kernel of the JAX package does
// (ctc_pytorch_tpu/ops/lstm_pallas_v2.py:42 _cell2 with bf16 weights).
// The design notes are in lstm_bidir.cu.
//
// ndir (1 or 2) is the number of directions, here and in every recurrence
// kernel of the package: gx is (T, B, ndir * nH) and ys (T, B, ndir * H), and
// direction 1, when there is one, walks time backward.  A unidirectional
// layer is the launch with ndir = 1; with ndir = 2 every index is what it
// was with the literal 2.

#pragma once

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

// Phase stamps of a grid step, for tools/probe_bwd_steps.py: built with
// GRID_STEP_STAMPS defined, thread 0 of CTA 0 adds the clock64() cycles
// since the stamp before to grid_step_cycles[i] at stamp i.  The package's
// build leaves them out.
#ifdef GRID_STEP_STAMPS
__device__ long long grid_step_cycles[8];
__device__ long long grid_stamp_last;
#define GRID_STAMP_START                                                  \
  if (threadIdx.x == 0 && blockIdx.x == 0) grid_stamp_last = clock64();
#define GRID_STAMP(i)                                                     \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                             \
    const long long now_ = clock64();                                     \
    grid_step_cycles[i] += now_ - grid_stamp_last;                        \
    grid_stamp_last = now_;                                               \
  }
#else
#define GRID_STAMP_START
#define GRID_STAMP(i)
#endif

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
// v as the stream type holds it
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
// come from w (L2).  kTrain: also store c_t into cs (same layout as ys) and
// hand the next step h_t as ys holds it (rounded to S).
template <typename S, bool kResident, bool kTrain>
__device__ __forceinline__ void step_item(
    const S* __restrict__ gx, const float* __restrict__ w,
    const float4* w_s, S* __restrict__ ys, S* __restrict__ cs,
    const float* h_prev, float* h_next, float* c, float* tiles, int t, int u0,
    int d, int B, int H, int ldh, int ndir) {
  const int tid = threadIdx.x;
  const int u = tid % kUnits;
  const int rq = tid / kUnits;  // row group, 0..31
  const int unit = u0 + u;
  const bool unit_ok = unit < H;
  const size_t h4 = 4 * (size_t)H;
  const int n_tiles = (H + kTileK - 1) / kTileK;
  // past-the-end units read a valid column and store nothing
  const float* w_col = w + min(unit, H - 1);
  const S* gx_t = gx + (size_t)t * B * ndir * h4 + d * h4;
  S* ys_t = ys + (size_t)t * B * ndir * H + (size_t)d * H;

  for (int r0 = 0; r0 < B; r0 += kRowTile) {
    stage(tiles, h_prev, 0, r0, H, ldh, tid);
    float acc[kRows][4];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int b = r0 + rq * kRows + j;
      const bool ok = unit_ok && b < B;
      const S* g = gx_t + (size_t)b * ndir * h4 + unit;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = ok ? load_f(g + q * H) : 0.f;
    }
    GRID_STAMP(0)  // the gate inputs loaded, the first tile issued
    for (int kt = 0; kt < n_tiles; ++kt) {
      if (kt + 1 < n_tiles) {
        stage(tiles + ((kt + 1) & 1) * kTileFloats, h_prev, (kt + 1) * kTileK,
              r0, H, ldh, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile kt (and, first, w_s) visible to all
      GRID_STAMP(1)  // the staging: copies issued, waited for, the barrier
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
      GRID_STAMP(2)  // the product of the tile and the barrier after it
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
      S* y = ys_t + (size_t)b * ndir * H + unit;
      store_f(y, hn);
      if constexpr (kTrain) {
        h_next[(size_t)unit * ldh + b] = load_f(y);
        store_f(cs + (y - ys), cn);
      } else {
        h_next[(size_t)unit * ldh + b] = hn;
      }
    }
    GRID_STAMP(3)  // the gate math and the stores
  }
}

// Work item i = (direction i / groups, units from (i % groups) * kUnits),
// over ndir * groups items.
// With kResident the grid has one CTA per item and each CTA keeps its item's
// weights in shared memory for the whole run; otherwise (large H) a smaller
// co-resident grid strides over the items and reads the weights from L2.
template <typename S, bool kResident, bool kTrain>
__global__ void __launch_bounds__(32 * kUnits)
    lstm_bidir_kernel(const S* __restrict__ gx, const float* __restrict__ w_hh,
                      S* __restrict__ ys, S* __restrict__ cs, float* hbuf,
                      float* cbuf, int T, int B, int H, int ldh, int ndir) {
  extern __shared__ float4 smem[];
  float4* w_s = smem;  // kResident: [H][kUnits], (i, f, g, o) per unit
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
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (un < H) {
        const float* row = w + (size_t)k * h4 + un;
        v = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
      }
      w_s[idx] = v;
    }
  }

  cg::grid_group grid = cg::this_grid();
  GRID_STAMP_START
  for (int s = 0; s < T; ++s) {
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int d = item / groups;
      const int u0 = (item % groups) * kUnits;
      float* hT = hbuf + (size_t)d * 2 * H * ldh;  // [2][H][ldh], zeroed
      step_item<S, kResident, kTrain>(
          gx, w_hh + (size_t)d * H * h4, w_s, ys, cs,
          hT + (size_t)(s & 1) * H * ldh, hT + (size_t)((s + 1) & 1) * H * ldh,
          cbuf + (size_t)d * B * H,  // [B][H], zeroed by the caller
          tiles, d == 0 ? s : T - 1 - s, u0, d, B, H, ldh, ndir);
    }
    grid.sync();
    GRID_STAMP(4)  // grid.sync()
  }
}

size_t smem_bytes(int H, bool resident) {
  return (resident ? (size_t)H * kUnits * sizeof(float4) : 0) +
         2 * (size_t)kTileFloats * sizeof(float);
}

// Cooperative launch of a recurrence kernel of 32 * kUnits threads over
// `items` work items.  one_cta_per_item (weights resident in shared memory):
// only when that whole grid can be co-resident, which a cooperative launch
// needs; otherwise as many CTAs as can be, at most one per item.  Sets
// *fits = 0 and launches nothing when the shared memory or the grid does not
// fit.
inline cudaError_t launch_cooperative(const void* kernel, size_t smem,
                                      int items, bool one_cta_per_item,
                                      void** args, cudaStream_t stream,
                                      int* fits) {
  *fits = 0;
  if (smem > 232448) return cudaSuccess;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * kUnits, smem);
  if (err != cudaSuccess) return err;
  const int capacity = per_sm * sms;
  if (capacity < 1 || (one_cta_per_item && items > capacity))
    return cudaSuccess;
  *fits = 1;
  err = cudaLaunchCooperativeKernel(
      kernel, dim3(items < capacity ? items : capacity), dim3(32 * kUnits),
      args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Resident weights while the grid fits (H <= 4 * SMs with two directions,
// see lstm_bidir.cu); past that the weights stay in L2.  cs is written only
// when kTrain.
template <typename S, bool kTrain>
cudaError_t launch(const void* gx, const void* w_hh, void* ys, void* cs,
                   void* hbuf, void* cbuf, int T, int B, int H, int ldh,
                   int ndir, cudaStream_t stream) {
  void* args[] = {&gx, &w_hh, &ys, &cs, &hbuf, &cbuf, &T, &B, &H, &ldh, &ndir};
  const int items = ndir * ((H + kUnits - 1) / kUnits);
  int fits = 0;
  cudaError_t err = launch_cooperative(
      reinterpret_cast<const void*>(lstm_bidir_kernel<S, true, kTrain>),
      smem_bytes(H, true), items, true, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  err = launch_cooperative(
      reinterpret_cast<const void*>(lstm_bidir_kernel<S, false, kTrain>),
      smem_bytes(H, false), items, false, args, stream, &fits);
  if (err != cudaSuccess || fits) return err;
  return cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace
