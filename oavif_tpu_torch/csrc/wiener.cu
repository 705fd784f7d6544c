// The AV1 Wiener loop-restoration filter over a width shard: 7-tap
// separable integer convolution per 64-row stripe band (spec 7.17.4), with
// the stripe sandwich's row selection (spec 7.17.3: rows outside the
// stripe read the deblocked frame, at most 2 rows past its edge).
//
// Replaces oavif_tpu/av1/restoration_sharded.py:57 filter_plane (inside
// apply_wiener_sharded :33, jit :106). The 3-column halos come in with the
// input: the caller exchanges them between ranks with edge replication at
// the frame's two ends (oavif_tpu_torch/parallel.py halo_exchange), so a
// shard's output is the host filter's (oavif_tpu_torch/av1/restoration.py
// apply_wiener) bit for bit: every sum is the same int32 sum.
//
// What bounds it on the H100: 14 multiply-adds and a few clamps per pixel
// against 8 bytes read (two int32 planes, most rows from one of them) and
// 4 written, so device-memory bytes bound it (in int32 the card would do
// the arithmetic ~20x faster than it can move the bytes). The design: one
// block per (64-column tile, stripe band) keeps the band's source rows and
// their halo (at most 70 x 70 int32) in shared memory, runs the
// horizontal pass into a shared intermediate and the vertical pass out of
// it, and writes each output once; every input byte is read once per
// tile, plus the 6 halo columns and 6 sandwich rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        (oavif_tpu_torch/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 64;                // output columns per block
constexpr int kBandMax = 64;           // rows of a stripe band
constexpr int kRows = kBandMax + 6;    // source rows of a band
constexpr int kCols = kTW + 6;         // source columns of a tile
constexpr int kThreads = 256;
constexpr int kFilterBits = 7;
constexpr int kRound0 = 3, kRound1 = 11;

// Band b covers output rows [r0, r1) of stripe [ss, se] (inclusive): the
// first band ends at row 56, the others are 64 rows (restoration.py
// _band_rows over [0, h)).
__device__ __forceinline__ void band(int b, int h, int* r0, int* r1, int* ss,
                                     int* se) {
  *r0 = b == 0 ? 0 : 56 + 64 * (b - 1);
  *r1 = min(h, b == 0 ? 56 : *r0 + 64);
  *ss = 64 * ((*r0 + 8) / 64) - 8;
  *se = *ss + 63;
}

__global__ void __launch_bounds__(kThreads)
wiener_kernel(const int32_t* __restrict__ cdef,
              const int32_t* __restrict__ deblk, int h, int w, int bitdepth,
              const int32_t* __restrict__ taps, int32_t* __restrict__ out) {
  __shared__ int32_t src[kRows][kCols];
  __shared__ int32_t inter[kRows][kTW];
  __shared__ int32_t vf[7], hf[7];
  int r0, r1, ss, se;
  band(blockIdx.y, h, &r0, &r1, &ss, &se);
  const int bh = r1 - r0;
  const int x0 = blockIdx.x * kTW;
  const int we = w + 6;  // the shard's columns and its two 3-column halos
  const int tid = threadIdx.x;
  if (tid < 7) {
    vf[tid] = taps[tid];
    hf[tid] = taps[7 + tid];
  }
  // the band's source rows: clamp to the frame, then rows outside the
  // stripe come from the deblocked frame, at most 2 rows past its edge
  for (int i = tid; i < (bh + 6) * kCols; i += kThreads) {
    const int j = i / kCols, c = i - (i / kCols) * kCols;
    const int y = min(max(r0 - 3 + j, 0), h - 1);
    const int32_t* plane = cdef;
    int row = y;
    if (y < ss) {
      plane = deblk;
      row = max(ss - 2, y);
    } else if (y > se) {
      plane = deblk;
      row = min(se + 2, y);
    }
    const int gc = x0 + c;
    src[j][c] = gc < we ? plane[static_cast<long long>(row) * we + gc] : 0;
  }
  __syncthreads();

  const int offset = 1 << (bitdepth + kFilterBits - kRound0 - 1);
  const int limit = (1 << (bitdepth + 1 + kFilterBits - kRound0)) - 1;
  for (int i = tid; i < (bh + 6) * kTW; i += kThreads) {
    const int j = i / kTW, c = i - (i / kTW) * kTW;
    int32_t s = 0;
#pragma unroll
    for (int t = 0; t < 7; ++t) s += hf[t] * src[j][c + t];
    inter[j][c] = min(max((s + (1 << (kRound0 - 1))) >> kRound0, -offset),
                      limit - offset);
  }
  __syncthreads();

  const int hi = (1 << bitdepth) - 1;
  for (int i = tid; i < bh * kTW; i += kThreads) {
    const int r = i / kTW, c = i - (i / kTW) * kTW;
    if (x0 + c >= w) continue;
    int32_t s = 0;
#pragma unroll
    for (int t = 0; t < 7; ++t) s += vf[t] * inter[r + t][c];
    const int32_t v = (s + (1 << (kRound1 - 1))) >> kRound1;
    out[static_cast<long long>(r0 + r) * w + x0 + c] = min(max(v, 0), hi);
  }
}

}  // namespace

// cdef, deblk: (h, w + 6) int32, a shard with 3 columns of halo each side;
// taps: 14 int32, the vertical then the horizontal 7-tap filter; out:
// (h, w) int32. bitdepth 8 or 10. Returns cudaGetLastError().
extern "C" int wiener_bands(const int32_t* cdef, const int32_t* deblk, int h,
                            int w, int bitdepth, const int32_t* taps,
                            int32_t* out, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || (bitdepth != 8 && bitdepth != 10))
    return cudaErrorInvalidValue;
  const int bands = h <= 56 ? 1 : 1 + (h - 56 + 63) / 64;
  const dim3 grid((w + kTW - 1) / kTW, bands);
  wiener_kernel<<<grid, kThreads, 0, stream>>>(cdef, deblk, h, w, bitdepth,
                                               taps, out);
  return static_cast<int>(cudaGetLastError());
}
