// Frame planner K1: the whole planning step in one kernel (planner_plan).
//
// Replaces oavif_tpu/av1/encode_tpu.py _plan_device_body (jit :363): the
// exact per-block, per-mode intra-prediction SSD at the 64, 32 and 16 grids
// (_mode_ssd with _grid_edges, _predict_modes and
// _predict_directional_modes), the DC SSD of both chroma planes at the 64
// grid, and the epilogue that turns them into the packed int32 plan
// (argmins, runner-up and nominee packing, the 64-NONE flat gates, the
// 32-split gate). Its plain version is plan_device_plain in
// oavif_tpu_torch/av1/encode_tpu.py, bit for bit.
//
// Every input of a superblock's (SB's) packed entries is local to the SB:
// its 64-grid SSDs, those of its four 32-blocks and sixteen 16-blocks, its
// chroma DC SSDs, and the 2x2 sums k32 and k16. So one 256-thread CTA per
// SB reads each pixel once, computes every SSD exactly, runs the whole
// epilogue and writes its 25 entries; no CTA needs another's results, and
// a plan is one launch.
//
// - Staging: the SB's 65x65 window of the (+1,+1)-padded luma plane (the
//   row above and the column left included) goes to shared memory once.
//   Each block's edge vector is built from it with the unavailability
//   fills of intra_edges.cuh, taken by the block's grid index in the frame
//   (the staged border is pad_plane's base-1 / base+1, not the fill); the
//   chroma edges come from device memory the same way. Each block's DC
//   is a warp-reduced sum of its edges.
// - Scoring: warp w owns a 16x32 strip of 32-block w >> 1 (rows
//   16 * (w & 1) on), i.e. two whole 16-blocks; lane (r, h) owns the 8
//   pixels of row r, columns 8h..8h+7 in each. Every pixel is scored once
//   against all its luma modes: 5, 7 or 13 at the 16 grid, 7 at 32, 7 at
//   64. The six directional modes at the 16 grid take their two taps from
//   a packed table that each CTA stages into shared memory once, laid out
//   so that a warp's 32 lanes read 32 consecutive words. Sums are uint32
//   per lane and reduced by shuffles within the warp only: a 16-block's
//   SSD is one warp's sum, a 32-block's two warps', the SB's all eight
//   (added in 64 bits). Every thread also scores 16 pixels of u and of v
//   against their 64-grid DC.
// - Epilogue, per SB, in float32 with each rounding that torch makes:
//   SSD -> float32 rounded to nearest; x 1.4f on the 16 grid's directional
//   columns; minima over the first five modes; argmins as a strict '<'
//   scan in mode order (the first index on ties), the runner-up with the
//   best set to +inf; (a00 + a01) + (a10 + a11) for k32 and k16; the gate
//   constants dq*dq, (4 dq) dq and ((4096 dq) dq) / 64 come from the host
//   in float32. __fadd_rn / __fmul_rn keep nvcc from contracting anything.
//
// Exactness: predictions are the reference's integer-valued formulas
// (DC floor division, SMOOTH >> 9, SMOOTH_V/H >> 8, PAETH, directional
// (w0*e0 + w1*e1 + 16) >> 5 with edges replicated past P), shared with the
// yardstick kernel below. The sums stay exact integers: pixels lie in
// [0, 2^bitdepth) with bitdepth 8 or 10 (the wrapper refuses others), so
// one err^2 is at most 1023^2 and even a whole 64x64 block's sum,
// 4096 * 1023^2 = 4,286,582,784, fits a uint32.
//
// What bounds it on the H100: at 3840x2160 it reads 48.9 MB of int16
// planes (0.015 ms at 3.35 TB/s) against about 0.93 G integer operations
// (27 luma pixel-modes and 2 chroma DC ones per pixel, each its
// prediction, with the terms constant along a row or column hoisted, plus
// difference and square-and-add): 0.55 G on the ALU pipe, 0.033 ms at
// 132 SMs x 64 lanes x 1.98 GHz, beside 0.38 G IMADs on the FMA pipe:
// bound by integer throughput (chip_smoke.py plan_ops has the count).
// The design keeps every intermediate in registers or shared
// memory, reads each pixel once, and does no block-wide reduction per
// block and mode. A frame of fewer than 132 SBs leaves SMs idle (64 CTAs
// at 512x512): there one CTA's latency is the kernel's time.
//
// mode_ssd_kernel / planner_mode_ssd, the first planner kernel (one CTA
// per image block and grid, one launch per grid and plane, the epilogue
// in torch), stays as the yardstick that no path launches: it gives the
// "before" times in the same call and is held to the plain SSD.
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
constexpr int kModes = 7;    // N_MODES: DC, V, H, SMOOTH, PAETH, SMOOTH_V/H
constexpr int kBase = 5;     // N_BASE: the modes of the partition minima

// Predictions of modes [0, NM) (NM <= 7) at one pixel: a = above[c],
// l = left[r], cr the corner, wr / wc the smooth weights of row / column,
// below = left[P-1], right = above[P-1].
template <int NM>
__device__ __forceinline__ void base_preds(int dc, int a, int l, int cr,
                                           int wr, int wc, int below,
                                           int right, int* pred) {
  pred[0] = dc;
  if constexpr (NM >= 5) {
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
  }
}

// ---------------------------------------------------------------------------
// The yardstick: one CTA per image block of one grid, SSD only.

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
    base_preds<NM < kModes ? NM : kModes>(dc_s, edge[1 + c], edge[L + 1 + r],
                                          cr, w_s[r], w_s[c], below, right,
                                          pred);
    if constexpr (NM >= 13) {
#pragma unroll
      for (int m = 0; m < kDirModes; ++m) {
        const int t = 2 * (m * P * P + idx);
        pred[7 + m] = (tap_w[t] * edge[tap_idx[t]] +
                       tap_w[t + 1] * edge[tap_idx[t + 1]] + 16) >> 5;
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

// ---------------------------------------------------------------------------
// The fused plan: one CTA per SB.

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block of one grid as a lane's row of it sees it.
struct BlockRow {
  const int* e;  // edge vector [corner, above.., corner, left..]
  const int* w;  // the grid's smooth weights
  int dc, l, wr, cr, below, right;
};

template <int P>
__device__ __forceinline__ BlockRow block_row(const int* e, const int* w,
                                              int dc, int r) {
  constexpr int L = 2 * P + 1;
  return {e, w, dc, e[L + 1 + r], w[r], e[0], e[L + P], e[P]};
}

// Adds err^2 of pixel x at column c of its block under modes [0, NM).
template <int NM>
__device__ __forceinline__ void score(const BlockRow& b, int c, int x,
                                      unsigned* acc) {
  int pred[NM];
  base_preds<NM>(b.dc, b.e[1 + c], b.l, b.cr, b.wr, b.w[c], b.below,
                 b.right, pred);
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int e = pred[m] - x;
    acc[m] += static_cast<unsigned>(e * e);
  }
}

// Directional mode from a packed tap (i0 | i1 << 8 | w1 << 16; w0 = 32 - w1).
__device__ __forceinline__ int dir_pred(const int* e, unsigned t) {
  const int i0 = t & 0xff, i1 = (t >> 8) & 0xff, w1 = t >> 16;
  return ((32 - w1) * e[i0] + w1 * e[i1] + 16) >> 5;
}

// torch.argmin over s[lo, hi): a strict '<' scan, the first index on ties;
// *val gets the minimum. skip (>= 0) counts as +inf (the runner-up).
template <int N>
__device__ __forceinline__ int argmin(const float* s, int lo, int hi,
                                      int skip, float* val) {
  int best = 0;
  float bv = __int_as_float(0x7f800000);  // +inf
#pragma unroll
  for (int m = 0; m < N; ++m) {
    if (m < lo || m >= hi || m == skip) continue;
    if (s[m] < bv) {
      bv = s[m];
      best = m;
    }
  }
  *val = bv;
  return best;
}

__device__ __forceinline__ float min_base(const float* s) {
  float v = s[0];
#pragma unroll
  for (int m = 1; m < kBase; ++m) v = fminf(v, s[m]);
  return v;
}

// mode16 of one 16-block from its uint32 SSDs (plan_device_plain's rules).
template <int NM>
__device__ __forceinline__ int mode16(const float* s, int duel_level) {
  constexpr int kNd = NM < kModes ? NM : kModes;
  float v_nd, v_dir, v;
  const int nd = argmin<NM>(s, 0, kNd, -1, &v_nd);
  if (duel_level >= 1) {
    const int best = argmin<NM>(s, 0, NM, -1, &v);
    return best + ((argmin<NM>(s, 0, NM, best, &v) + 1) << 8);
  }
  if constexpr (NM > kModes) {
    const int dir = argmin<NM>(s, kModes, NM, -1, &v_dir);
    return nd + (v_dir < v_nd ? (dir + 1) << 8 : 0);
  }
  return nd;
}

template <int NM>
__global__ void __launch_bounds__(kThreads, 2)
plan_kernel(const int16_t* __restrict__ y, const int16_t* __restrict__ u,
            const int16_t* __restrict__ v, int ld, int sbx, int base,
            int duel_level, int split_on, float pen32, float pen64,
            float flat_gate, const int32_t* __restrict__ smw64,
            const int32_t* __restrict__ smw32,
            const int32_t* __restrict__ smw16,
            const uint32_t* __restrict__ taps16, int32_t* __restrict__ out) {
  constexpr int kB = NM < kModes ? NM : kModes;  // non-directional at 16
  constexpr int kT = 65, kTs = 66;               // staged window, its stride
  constexpr int L16 = 33, L32 = 65, L64 = 129;
  constexpr int kTaps = NM > kModes ? kDirModes * 256 : 1;
  __shared__ int16_t tile[kT][kTs];
  __shared__ int e16[16][2 * L16];
  __shared__ int e32[4][2 * L32];
  __shared__ int e64[3][2 * L64];  // y, u, v
  __shared__ int w16[16], w32[32], w64[64];
  __shared__ uint32_t taps[kTaps];
  __shared__ int dc[16 + 4 + 3];   // 16-blocks, 32-blocks, SB y, u, v
  __shared__ unsigned s32[kWarps][kModes], s64[kWarps][kModes];
  __shared__ unsigned suv[kWarps][2];
  __shared__ float best16[16];

  const int sb = blockIdx.x;
  const int sy = sb / sbx, sx = sb - sy * sbx;
  const int n64 = gridDim.x, n32 = 4 * n64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the SB's padded row above and column left
  const long long o = static_cast<long long>(64 * sy) * ld + 64 * sx;

  // 1. stage the luma window, the tables and the chroma edges
  for (int i = tid; i < kT * kT; i += kThreads) {
    const int r = i / kT, c = i - r * kT;
    tile[r][c] = y[o + r * ld + c];
  }
  if (tid < 64) w64[tid] = smw64[tid];
  if (tid < 32) w32[tid] = smw32[tid];
  if (tid < 16) w16[tid] = smw16[tid];
  if constexpr (NM > kModes)
    for (int i = tid; i < kTaps; i += kThreads) taps[i] = taps16[i];
  {
    const oavif::Pix pu{u + o, ld}, pv{v + o, ld};
    for (int i = tid; i < 2 * L64; i += kThreads) {
      e64[1][i] = oavif::edge_at<64>(pu, sy == 0, sx == 0, base, i);
      e64[2][i] = oavif::edge_at<64>(pv, sy == 0, sx == 0, base, i);
    }
  }
  __syncthreads();

  // 2. luma edges from the window, filled by each block's place in the
  //    frame
  for (int i = tid; i < 16 * 2 * L16; i += kThreads) {
    const int b = i / (2 * L16), k = i - b * (2 * L16);
    const int ey = b >> 2, ex = b & 3;
    e16[b][k] = oavif::edge_at<16>(oavif::Pix{&tile[16 * ey][16 * ex], kTs},
                                   sy == 0 && ey == 0, sx == 0 && ex == 0,
                                   base, k);
  }
  for (int i = tid; i < 4 * 2 * L32; i += kThreads) {
    const int b = i / (2 * L32), k = i - b * (2 * L32);
    const int dy = b >> 1, dx = b & 1;
    e32[b][k] = oavif::edge_at<32>(oavif::Pix{&tile[32 * dy][32 * dx], kTs},
                                   sy == 0 && dy == 0, sx == 0 && dx == 0,
                                   base, k);
  }
  for (int i = tid; i < 2 * L64; i += kThreads)
    e64[0][i] = oavif::edge_at<64>(oavif::Pix{&tile[0][0], kTs}, sy == 0,
                                   sx == 0, base, i);
  __syncthreads();

  // 3. every block's DC: (sum above + sum left + P) >> log2(2P)
  for (int b = warp; b < 23; b += kWarps) {
    const int P = b < 16 ? 16 : (b < 20 ? 32 : 64);
    const int* e = b < 16 ? e16[b] : (b < 20 ? e32[b - 16] : e64[b - 20]);
    int s = 0;
    for (int k = lane; k < P; k += 32) s += e[1 + k] + e[2 * P + 2 + k];
    s = static_cast<int>(warp_sum(static_cast<unsigned>(s)));
    if (lane == 0) dc[b] = (s + P) >> (P == 16 ? 5 : (P == 32 ? 6 : 7));
  }
  __syncthreads();

  // 4. score: this lane's 8 pixels in each of 16-blocks bA and bA + 1
  const int q = warp >> 1, dy = q >> 1, dx = q & 1;
  const int r = lane >> 1, h = lane & 1;
  const int ey = 2 * dy + (warp & 1);
  const int bA = 4 * ey + 2 * dx;
  const int r32 = 16 * (warp & 1) + r, R = 32 * dy + r32;
  const BlockRow rowA = block_row<16>(e16[bA], w16, dc[bA], r);
  const BlockRow rowB = block_row<16>(e16[bA + 1], w16, dc[bA + 1], r);
  const BlockRow row32 = block_row<32>(e32[q], w32, dc[16 + q], r32);
  const BlockRow row64 = block_row<64>(e64[0], w64, dc[20], R);

  unsigned accA[NM], accB[NM], acc32[kModes], acc64[kModes];
#pragma unroll
  for (int m = 0; m < NM; ++m) accA[m] = accB[m] = 0u;
#pragma unroll
  for (int m = 0; m < kModes; ++m) acc32[m] = acc64[m] = 0u;

  const int16_t* px = &tile[1 + R][1 + 32 * dx];
  for (int k = 0; k < 8; ++k) {
    const int c = 8 * h + k;  // column in each 16-block
    const int xa = px[c], xb = px[16 + c];
    score<kB>(rowA, c, xa, accA);
    score<kB>(rowB, c, xb, accB);
    score<kModes>(row32, c, xa, acc32);
    score<kModes>(row32, 16 + c, xb, acc32);
    score<kModes>(row64, 32 * dx + c, xa, acc64);
    score<kModes>(row64, 32 * dx + 16 + c, xb, acc64);
    if constexpr (NM > kModes) {
#pragma unroll
      for (int m = 0; m < kDirModes; ++m) {
        const uint32_t t = taps[(m * 8 + k) * 32 + lane];
        const int ea = dir_pred(rowA.e, t) - xa;
        const int eb = dir_pred(rowB.e, t) - xb;
        accA[kModes + m] += static_cast<unsigned>(ea * ea);
        accB[kModes + m] += static_cast<unsigned>(eb * eb);
      }
    }
  }
  unsigned accu = 0u, accv = 0u;
  {
    const int dcu = dc[21], dcv = dc[22];
    const int16_t* uo = u + o + ld + 1;
    const int16_t* vo = v + o + ld + 1;
    for (int i = tid; i < 64 * 64; i += kThreads) {
      const int off = (i >> 6) * ld + (i & 63);
      const int eu = dcu - uo[off], ev = dcv - vo[off];
      accu += static_cast<unsigned>(eu * eu);
      accv += static_cast<unsigned>(ev * ev);
    }
  }

  // 5. reduce in the warp; the 16-grid epilogue on lanes 0 and 1
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    accA[m] = warp_sum(accA[m]);
    accB[m] = warp_sum(accB[m]);
  }
#pragma unroll
  for (int m = 0; m < kModes; ++m) {
    acc32[m] = warp_sum(acc32[m]);
    acc64[m] = warp_sum(acc64[m]);
  }
  accu = warp_sum(accu);
  accv = warp_sum(accv);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < kModes; ++m) {
      s32[warp][m] = acc32[m];
      s64[warp][m] = acc64[m];
    }
    suv[warp][0] = accu;
    suv[warp][1] = accv;
  }
  if (lane < 2) {
    float s[NM];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      s[m] = __uint2float_rn(lane ? accB[m] : accA[m]);
      if (m >= kModes) s[m] = __fmul_rn(s[m], 1.4f);
    }
    const int ex = 2 * dx + lane;
    best16[4 * ey + ex] = min_base(s);
    out[n64 + 2 * n32 + (4 * sy + ey) * (4 * sbx) + 4 * sx + ex] =
        mode16<NM>(s, duel_level);
  }
  __syncthreads();

  // 6. the 32 grid (threads 0-3) and the SB (thread 32)
  if (tid < 4) {
    const int qy = tid >> 1, qx = tid & 1;
    float s[kModes], v0;
#pragma unroll
    for (int m = 0; m < kModes; ++m)
      s[m] = __ull2float_rn(static_cast<unsigned long long>(s32[2 * tid][m]) +
                            s32[2 * tid + 1][m]);
    const float b32 = min_base(s);
    int mode = argmin<kModes>(s, 0, kModes, -1, &v0);
    if (duel_level >= 2)
      mode += (argmin<kModes>(s, 0, kModes, mode, &v0) + 1) << 8;
    const float* k = &best16[8 * qy + 2 * qx];
    const float k16 = __fadd_rn(__fadd_rn(k[0], k[1]), __fadd_rn(k[4], k[5]));
    const int at = (2 * sy + qy) * (2 * sbx) + 2 * sx + qx;
    out[n64 + at] = mode;
    out[n64 + n32 + at] = split_on && __fadd_rn(k16, pen32) < b32;
  } else if (tid == 32) {
    float s[kModes], b32[4], v0;
#pragma unroll
    for (int m = 0; m < kModes; ++m) {
      unsigned long long t = 0ull;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += s64[w][m];
      s[m] = __ull2float_rn(t);
    }
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      float t[kModes];
#pragma unroll
      for (int m = 0; m < kModes; ++m)
        t[m] = __ull2float_rn(
            static_cast<unsigned long long>(s32[2 * qq][m]) +
            s32[2 * qq + 1][m]);
      b32[qq] = min_base(t);
    }
    unsigned long long tu = 0ull, tv = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tu += suv[w][0];
      tv += suv[w][1];
    }
    const float b64 = min_base(s);
    const float k32 = __fadd_rn(__fadd_rn(b32[0], b32[1]),
                                __fadd_rn(b32[2], b32[3]));
    const bool none = b64 <= __fadd_rn(k32, pen64) && b64 <= flat_gate &&
                      __ull2float_rn(tu) <= flat_gate &&
                      __ull2float_rn(tv) <= flat_gate;
    out[sb] = none ? argmin<kModes>(s, 0, kModes, -1, &v0) + 1 : 0;
  }
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

// y, u, v: (64*sby+1, >= 64*sbx+1) (+1,+1)-padded int16 planes of one
// stride ld, pixels in [0, 2^bitdepth) for bitdepth 8 or 10; base =
// 2^(bitdepth-1). nmodes 5, 7 or 13 at the 16 grid; duel_level 0-2;
// split_on: qindex <= 90. pen32 = dq*dq, pen64 = (4 dq) dq, flat_gate =
// ((4096 dq) dq) / 64 in float32. smw64/32/16: int32 smooth weights.
// taps16: (6, 8, 32) packed P = 16 directional taps, entry [m][k][2r + h]
// for pixel (r, 8h + k) (read only when nmodes == 13). out: (25*sby*sbx,)
// int32, the packed plan: plan64, mode32, split32, mode16. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int planner_plan(const int16_t* y, const int16_t* u,
                            const int16_t* v, int ld, int sby, int sbx,
                            int base, int nmodes, int duel_level,
                            int split_on, float pen32, float pen64,
                            float flat_gate, const int32_t* smw64,
                            const int32_t* smw32, const int32_t* smw16,
                            const uint32_t* taps16, int32_t* out,
                            cudaStream_t stream) {
  if (sby <= 0 || sbx <= 0 || ld < 64 * sbx + 1 || duel_level < 0 ||
      duel_level > 2)
    return cudaErrorInvalidValue;
  const dim3 grid(sby * sbx);
  switch (nmodes) {
    case 5:
      plan_kernel<5><<<grid, kThreads, 0, stream>>>(
          y, u, v, ld, sbx, base, duel_level, split_on, pen32, pen64,
          flat_gate, smw64, smw32, smw16, taps16, out);
      break;
    case 7:
      plan_kernel<7><<<grid, kThreads, 0, stream>>>(
          y, u, v, ld, sbx, base, duel_level, split_on, pen32, pen64,
          flat_gate, smw64, smw32, smw16, taps16, out);
      break;
    case 13:
      plan_kernel<13><<<grid, kThreads, 0, stream>>>(
          y, u, v, ld, sbx, base, duel_level, split_on, pen32, pen64,
          flat_gate, smw64, smw32, smw16, taps16, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
