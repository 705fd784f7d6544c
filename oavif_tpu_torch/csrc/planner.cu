// Frame planner: exact per-block, per-mode intra-prediction SSD.
//
// Replaces the heavy part of oavif_tpu/av1/encode_tpu.py
// _plan_device_body: _mode_ssd at the 64, 32 and 16 grids (with
// _grid_edges, _predict_modes and _predict_directional_modes) plus the
// DC-only chroma SSD of the 64-grid flat gate. The epilogue (argmins,
// nominee packing, partition gates) stays in torch
// (oavif_tpu_torch/av1/encode_tpu.py:plan_device).
//
// One thread block per image block. The block builds its above/left/
// corner edge vector with the decoder's unavailability fills in shared
// memory straight from the (+1,+1)-padded int16 plane (intra_edges.cuh,
// shared with device_stage.cu), then every thread
// predicts its pixels for every mode in integer arithmetic and
// accumulates err^2 per mode in 64 bits; a warp-shuffle plus shared-memory
// reduction gives one exact integer SSD per (block, mode). The
// (n, nmodes, P, P) prediction tensor of the reference never exists in
// device memory.
//
// What bounds it on the H100: each pixel is read once per grid (a 4K
// frame's luma is ~16 MB of int16 over the three grids), against
// O(nmodes) integer operations per pixel plus one block reduction per
// mode, so it is bound by integer issue and reductions, not by HBM
// bandwidth; at 512^2 a launch has only 64-1024 blocks and is bound by
// launch latency. The design keeps every intermediate in registers or
// shared memory and makes the global reads coalesced (consecutive threads
// read consecutive pixels of a row). wgmma and TMA do not apply: there is
// no matrix product left once the reference's directional matmul becomes
// a two-tap gather.
//
// Exactness: predictions follow the reference's integer-valued float
// formulas bit for bit (DC floor division, SMOOTH >> 9, SMOOTH_V/H >> 8,
// PAETH, directional (w0*e0 + w1*e1 + 16) >> 5 with edges replicated past
// P). The SSD is exact: at 10 bits one pixel's err^2 reaches 1023^2, so
// a 64x64 sum reaches ~4.3e9 and would overflow an int32 accumulator.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (oavif_tpu_torch/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_edges.cuh"

namespace {

using oavif::Log2;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDirModes = 6;

template <int P, int NM>
__global__ void __launch_bounds__(kThreads)
mode_ssd_kernel(const int16_t* __restrict__ plane, int ld, int nbx,
                int base, const int32_t* __restrict__ smw,
                const int16_t* __restrict__ tap_idx,
                const int16_t* __restrict__ tap_w,
                unsigned long long* __restrict__ out) {
  // edge = [corner, above[0..P), above[P-1] x P,
  //         corner, left[0..P),  left[P-1]  x P]  (the reference's
  //         am1 ++ lm1 vector that the directional taps index)
  constexpr int L = 2 * P + 1;
  __shared__ int edge[2 * L];
  __shared__ int w_s[P];
  __shared__ int dc_s;
  __shared__ unsigned long long red[kWarps][NM];

  const int blk = blockIdx.x;
  const int bi = blk / nbx, bj = blk - (blk / nbx) * nbx;
  const int y0 = bi * P, x0 = bj * P;  // padded row above / column left
  const int tid = threadIdx.x;

  for (int k = tid; k < P; k += kThreads) w_s[k] = smw[k];
  oavif::load_edges<P, kThreads>(plane, ld, bi, bj, base, edge);
  if (tid == 0) dc_s = oavif::dc_pred<P>(edge);
  __syncthreads();

  unsigned long long acc[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) acc[m] = 0ull;

  const int cr = edge[0];
  const int below = edge[L + P];  // left[P-1]
  const int right = edge[P];      // above[P-1]
  for (int idx = tid; idx < P * P; idx += kThreads) {
    const int r = idx >> Log2<P>::value;
    const int c = idx & (P - 1);
    const int x = plane[(1 + y0 + r) * ld + 1 + x0 + c];
    int pred[NM];
    pred[0] = dc_s;
    if constexpr (NM >= 5) {
      const int a = edge[1 + c], l = edge[L + 1 + r];
      const int wr = w_s[r], wc = w_s[c];
      pred[1] = a;
      pred[2] = l;
      pred[3] = (wr * a + (256 - wr) * below + wc * l + (256 - wc) * right +
                 256) >> 9;
      const int pa = abs(l - cr), pl = abs(a - cr), pc = abs(a + l - 2 * cr);
      pred[4] = (pa <= pl && pa <= pc) ? a : (pl <= pc ? l : cr);
      if constexpr (NM >= 7) {
        pred[5] = (wr * a + (256 - wr) * below + 128) >> 8;
        pred[6] = (wc * l + (256 - wc) * right + 128) >> 8;
      }
      if constexpr (NM >= 13) {
#pragma unroll
        for (int m = 0; m < kDirModes; ++m) {
          const int t = 2 * (m * P * P + idx);
          pred[7 + m] = (tap_w[t] * edge[tap_idx[t]] +
                         tap_w[t + 1] * edge[tap_idx[t + 1]] + 16) >> 5;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int e = pred[m] - x;
      acc[m] += static_cast<unsigned long long>(e * e);
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    unsigned long long v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][m] = v;
  }
  __syncthreads();
  if (tid < NM) {
    unsigned long long s = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    out[static_cast<long long>(blk) * NM + tid] = s;
  }
}

template <int P>
cudaError_t launch_p(int nmodes, dim3 grid, cudaStream_t stream,
                     const int16_t* plane, int ld, int nbx, int base,
                     const int32_t* smw, const int16_t* tap_idx,
                     const int16_t* tap_w, unsigned long long* out) {
  switch (nmodes) {
    case 1:
      mode_ssd_kernel<P, 1><<<grid, kThreads, 0, stream>>>(
          plane, ld, nbx, base, smw, tap_idx, tap_w, out);
      break;
    case 5:
      mode_ssd_kernel<P, 5><<<grid, kThreads, 0, stream>>>(
          plane, ld, nbx, base, smw, tap_idx, tap_w, out);
      break;
    case 7:
      mode_ssd_kernel<P, 7><<<grid, kThreads, 0, stream>>>(
          plane, ld, nbx, base, smw, tap_idx, tap_w, out);
      break;
    case 13:
      mode_ssd_kernel<P, 13><<<grid, kThreads, 0, stream>>>(
          plane, ld, nbx, base, smw, tap_idx, tap_w, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// plane: (>= nby*P+1, ld) int16, the (+1,+1)-padded plane, row stride ld.
// smw: (P,) int32 smooth weights. tap_idx/tap_w: (6, P*P, 2) int16
// directional taps (read only when nmodes == 13). out: (nby*nbx, nmodes)
// uint64. Launches on `stream` and returns cudaGetLastError().
extern "C" int planner_mode_ssd(const int16_t* plane, int ld, int nby,
                                int nbx, int P, int nmodes, int base,
                                const int32_t* smw, const int16_t* tap_idx,
                                const int16_t* tap_w, unsigned long long* out,
                                cudaStream_t stream) {
  if (nby <= 0 || nbx <= 0) return cudaErrorInvalidValue;
  const dim3 grid(nby * nbx);
  cudaError_t err;
  switch (P) {
    case 16:
      err = launch_p<16>(nmodes, grid, stream, plane, ld, nbx, base, smw,
                         tap_idx, tap_w, out);
      break;
    case 32:
      err = launch_p<32>(nmodes, grid, stream, plane, ld, nbx, base, smw,
                         tap_idx, tap_w, out);
      break;
    case 64:
      err = launch_p<64>(nmodes, grid, stream, plane, ld, nbx, base, smw,
                         tap_idx, tap_w, out);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
