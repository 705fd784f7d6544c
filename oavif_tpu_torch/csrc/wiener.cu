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
// the arithmetic ~20x faster than it can move the bytes): 0.0051 ms for
// one rank's 2160x966 shard. wiener_kernel takes one block of 4 warps per
// (64-column tile, stripe band): the band's source rows and halo (at most
// 70 x 70 int32) go to shared memory in one batch of independent loads
// per thread, int2 where the row stride allows; then each warp walks 16
// rows of the band down its 64 columns, two per lane, computing one
// intermediate row of the horizontal pass a step (4 shared int2 reads)
// into a 7-row register window and one output row from it. The first
// kernel, wiener_simple_kernel, which the source keeps as the yardstick,
// wrote the whole intermediate to a second shared array between two
// barriers and read it back 7 times an output; the two give the same bits.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, kernel alone by
// torch.profiler): wiener_kernel 0.0083 ms, wiener_simple_kernel 0.0131.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        (oavif_tpu_torch/kernels/build.py).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 64;                // output columns per block
constexpr int kBandMax = 64;           // rows of a stripe band
constexpr int kRows = kBandMax + 6;    // source rows of a band
constexpr int kCols = kTW + 6;         // source columns of a tile
constexpr int kThreads = 256;          // wiener_simple_kernel's block
constexpr int kSeg = 16;               // band rows a warp of wiener_kernel walks
constexpr int kThreads2 = kBandMax / kSeg * 32;  // wiener_kernel's block
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

// Stripe bands of an h-row plane.
inline int bands(int h) { return h <= 56 ? 1 : 1 + (h - 56 + 63) / 64; }

// The band's source row j (0 <= j < bh + 6; output row r reads rows r ..
// r + 6): clamp to the frame, then rows outside the stripe come from the
// deblocked frame, at most 2 rows past its edge.
__device__ __forceinline__ const int32_t* source_row(
    const int32_t* cdef, const int32_t* deblk, int h, int we, int r0, int ss,
    int se, int j) {
  const int y = min(max(r0 - 3 + j, 0), h - 1);
  if (y < ss) return deblk + static_cast<long long>(max(ss - 2, y)) * we;
  if (y > se) return deblk + static_cast<long long>(min(se + 2, y)) * we;
  return cdef + static_cast<long long>(y) * we;
}

// One block of kThreads2 / 32 warps per (64-column tile, stripe band). The band's
// source rows go to shared memory in one batch of independent loads per
// thread (int2 where the row stride and pointers allow, kVec); then warp g
// walks rows [16g, 16g + 16) of the band, lane p owning the tile's
// columns 2p and 2p + 1: each step computes one intermediate row of the
// horizontal pass from 4 shared int2 reads, keeps the last 7 in a register
// window, and writes one output row from it. No intermediate reaches
// shared memory and there is one barrier.
template <bool kVec>
__global__ void __launch_bounds__(kThreads2)
wiener_kernel(const int32_t* __restrict__ cdef,
              const int32_t* __restrict__ deblk, int h, int w, int bitdepth,
              const int32_t* __restrict__ taps, int32_t* __restrict__ out) {
  using Unit = typename std::conditional<kVec, int2, int32_t>::type;
  constexpr int kUnit = kVec ? 2 : 1;
  constexpr int kUnits = kCols / kUnit;   // per source row
  constexpr int kBatch = 20;              // loads of a thread in flight
  __shared__ __align__(16) int32_t src[kRows][kCols];
  int r0, r1, ss, se;
  band(blockIdx.y, h, &r0, &r1, &ss, &se);
  const int bh = r1 - r0;
  const int x0 = blockIdx.x * kTW;
  const int we = w + 6;
  const int tid = threadIdx.x;

  // one round of int2 units, two of int32 ones
  for (int i0 = 0; i0 < kRows * kUnits; i0 += kBatch * kThreads2) {
    Unit v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + tid + k * kThreads2;
      const int j = i / kUnits, u = i - j * kUnits;
      const int gc = x0 + u * kUnit;
      if (j < bh + 6 && gc < we) {
        v[k] = *reinterpret_cast<const Unit*>(
            source_row(cdef, deblk, h, we, r0, ss, se, j) + gc);
      } else {
        v[k] = Unit{};
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + tid + k * kThreads2;
      const int j = i / kUnits, u = i - j * kUnits;
      if (j < bh + 6) *reinterpret_cast<Unit*>(&src[j][u * kUnit]) = v[k];
    }
  }
  __syncthreads();

  const int warp = tid >> 5, p = tid & 31;
  const int rs = warp * kSeg, re = min(rs + kSeg, bh);
  if (rs >= bh) return;
  int hf[7], vf[7];
#pragma unroll
  for (int t = 0; t < 7; ++t) {
    vf[t] = taps[t];
    hf[t] = taps[7 + t];
  }
  const int offset = 1 << (bitdepth + kFilterBits - kRound0 - 1);
  const int limit = (1 << (bitdepth + 1 + kFilterBits - kRound0)) - 1;
  const int hi = (1 << bitdepth) - 1;
  // the horizontal pass at source row j, columns 2p and 2p + 1
  auto inter = [&](int j, int& i0, int& i1) {
    const int2* row = reinterpret_cast<const int2*>(&src[j][2 * p]);
    int a[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int2 x = row[q];
      a[2 * q] = x.x;
      a[2 * q + 1] = x.y;
    }
    int32_t s0 = 0, s1 = 0;
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      s0 += hf[t] * a[t];
      s1 += hf[t] * a[t + 1];
    }
    i0 = min(max((s0 + (1 << (kRound0 - 1))) >> kRound0, -offset),
             limit - offset);
    i1 = min(max((s1 + (1 << (kRound0 - 1))) >> kRound0, -offset),
             limit - offset);
  };
  int w0[7], w1[7];
#pragma unroll
  for (int t = 0; t < 6; ++t) inter(rs + t, w0[t], w1[t]);
  const int gc = x0 + 2 * p;
  for (int r = rs; r < re; ++r) {
    inter(r + 6, w0[6], w1[6]);
    int32_t s0 = 0, s1 = 0;
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      s0 += vf[t] * w0[t];
      s1 += vf[t] * w1[t];
    }
    const int o0 = min(max((s0 + (1 << (kRound1 - 1))) >> kRound1, 0), hi);
    const int o1 = min(max((s1 + (1 << (kRound1 - 1))) >> kRound1, 0), hi);
    int32_t* orow = out + static_cast<long long>(r0 + r) * w;
    if (kVec) {
      if (gc < w) *reinterpret_cast<int2*>(orow + gc) = make_int2(o0, o1);
    } else {
      if (gc < w) orow[gc] = o0;
      if (gc + 1 < w) orow[gc + 1] = o1;
    }
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      w0[t] = w0[t + 1];
      w1[t] = w1[t + 1];
    }
  }
}

// The first Wiener kernel, kept as the yardstick that wiener_kernel must
// equal bit for bit: the band's source rows and the horizontal pass's
// intermediate both in shared memory, one thread per element of each pass.
__global__ void __launch_bounds__(kThreads)
wiener_simple_kernel(const int32_t* __restrict__ cdef,
                     const int32_t* __restrict__ deblk, int h, int w,
                     int bitdepth, const int32_t* __restrict__ taps,
                     int32_t* __restrict__ out) {
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
  for (int i = tid; i < (bh + 6) * kCols; i += kThreads) {
    const int j = i / kCols, c = i - (i / kCols) * kCols;
    const int gc = x0 + c;
    src[j][c] =
        gc < we ? source_row(cdef, deblk, h, we, r0, ss, se, j)[gc] : 0;
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
  const dim3 grid((w + kTW - 1) / kTW, bands(h));
  // int2 rows where w (so w + 6) is even and every plane is 8-byte aligned
  const bool vec = w % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(cdef) | reinterpret_cast<uintptr_t>(deblk)
        | reinterpret_cast<uintptr_t>(out)) & 7) == 0;
  if (vec)
    wiener_kernel<true><<<grid, kThreads2, 0, stream>>>(
        cdef, deblk, h, w, bitdepth, taps, out);
  else
    wiener_kernel<false><<<grid, kThreads2, 0, stream>>>(
        cdef, deblk, h, w, bitdepth, taps, out);
  return static_cast<int>(cudaGetLastError());
}

// The yardstick kernel, with wiener_bands' arguments. On no path.
extern "C" int wiener_bands_simple(const int32_t* cdef, const int32_t* deblk,
                                   int h, int w, int bitdepth,
                                   const int32_t* taps, int32_t* out,
                                   cudaStream_t stream) {
  if (h <= 0 || w <= 0 || (bitdepth != 8 && bitdepth != 10))
    return cudaErrorInvalidValue;
  const dim3 grid((w + kTW - 1) / kTW, bands(h));
  wiener_simple_kernel<<<grid, kThreads, 0, stream>>>(cdef, deblk, h, w,
                                                      bitdepth, taps, out);
  return static_cast<int>(cudaGetLastError());
}
