// SSIMULACRA2 on the GPU: the pyramid front end, the Gaussian blur and the
// per-channel norms of the SSIM and edge maps, each batched over N
// candidates against one reference (the reference's vmapped _score_batch,
// oavif_tpu/metric/ssimulacra2.py:501).
//
// Replaces, in oavif_tpu/metric/ssimulacra2.py:
//   ssim2_pyramid  rgb8_to_linear (:236), linear_rgb_to_xyb_positive (:222)
//                  and downsample2 (:358);
//   ssim2_blur     _blur_fir (:332, through blur :319), five blurs per scale,
//                  and with a halo _blur_sharded (metric/sharded.py:67);
//   ssim2_blur_iir blur_iir (:309, _iir_pass_1d :287), the recursive
//                  Gaussian under OAVIF_METRIC_BLUR=iir;
//   ssim2_norms    _ssim_map_norms (:373) and _edge_diff_norms (:390).
// The feature assembly and the final nonlinearity stay in torch
// (oavif_tpu_torch/metric/ssimulacra2.py), as does every plain version.
//
// What bounds them on the H100: all three are elementwise or stencil work
// on float32 planes, a few to a few tens of flops per byte moved, far
// below the card's ratio of ~20 float32 flops per byte of HBM, so they are
// bound by device-memory bandwidth (and at 512x512 by launch latency).
// There is no matrix product, so no tensor cores, wgmma or TMA. What the
// design does about it:
//   - the pyramid reads each byte or pixel once and writes linear RGB and
//     XYB in the same pass, sRGB decoded through a 256-entry table;
//   - the blur keeps a 32x32 tile plus an 8-pixel halo of its inputs in
//     shared memory, forms the products (img2^2, img1*img2) there, runs
//     the horizontal then the vertical pass out of shared memory, and
//     writes the two (reference side) or three (distorted side) outputs
//     once; the reference planes are read with batch stride 0;
//   - the norms read the seven planes once and keep the three maps in
//     registers: only 6 float64 partial sums per block reach memory.
// Fusing blur and norms so that mu2, s22 and s12 never reach memory is
// left for later. The recursive blur is bound otherwise: each output
// depends on the one before it along the axis, so one thread walks one
// row (W pass) or one column (H pass) through a chain of dependent float32
// operations, and the row walk's loads do not coalesce. It keeps the
// reference's order of operations exactly (so it equals its plain
// version bit for bit) and is left simple: a tiled transpose before the W
// pass is the first thing to try for speed.
//
// Rounding: every float32 expression that the identical-image score of
// exactly 100 or the equality with the plain version depends on is written
// with explicit round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fmaf_rn), which nvcc never contracts, so
//   - the reference-side and distorted-side blurs of identical planes
//     give identical bits (the same taps, the same order, the same FMAs);
//   - s12 - mu1*mu2 and s11 - mu1*mu1 round alike, so an identical pair
//     gives d = 0 and artifact = detail = 0 exactly;
//   - the pyramid and the norms' maps repeat the plain version's roundings
//     (its torch ops never fuse; its two FMAs go through float64), except
//     cbrtf in the pyramid (<= 1 ulp against the plain version's float64
//     cube root).
// The sums run in float64 in a fixed order, with no atomics: a block
// reduces with warp shuffles and one shared-memory pass, and a second
// launch folds the per-block partials, so a repeated run is bit-identical.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        (oavif_tpu_torch/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// _pyramid_consts layout (oavif_tpu_torch/metric/ssimulacra2.py)
constexpr int kLut = 0;        // 256 linear values of the sRGB bytes
constexpr int kOpsin = 256;    // 3x3 opsin matrix, row-major
constexpr int kBias = 265;     // opsin bias
constexpr int kCbrtBias = 266; // its cube root
constexpr int kOffsets = 267;  // X', Y', B' offsets
constexpr int kConsts = 270;
constexpr int kMix = kConsts - kOpsin;

constexpr int kPyrThreads = 256;
constexpr int kPyrMaxBlocks = 8192;

// Positive XYB of one linear RGB pixel; k = consts + kOpsin.
__device__ __forceinline__ void xyb_positive(const float rgb[3],
                                             const float* k, float out[3]) {
  float g[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // the order of the reference's einsum under XLA, and of the plain
    // version: fma(m2, b, fma(m1, g, m0 * r))
    const float mixed =
        __fmaf_rn(k[3 * i + 2], rgb[2],
                  __fmaf_rn(k[3 * i + 1], rgb[1], __fmul_rn(k[3 * i], rgb[0])));
    const float v = fmaxf(__fadd_rn(mixed, k[kBias - kOpsin]), 0.0f);
    g[i] = __fsub_rn(cbrtf(v), k[kCbrtBias - kOpsin]);
  }
  const float x = __fmul_rn(__fsub_rn(g[0], g[1]), 0.5f);
  const float y = __fmul_rn(__fadd_rn(g[0], g[1]), 0.5f);
  out[0] = __fadd_rn(__fmul_rn(x, 14.0f), k[kOffsets - kOpsin]);
  out[1] = __fadd_rn(y, k[kOffsets + 1 - kOpsin]);
  out[2] = __fadd_rn(__fsub_rn(g[2], y), k[kOffsets + 2 - kOpsin]);
}

// Scale 0: rgb (N, H, W, 3) uint8 -> lin, xyb (N, 3, H, W) float32.
__global__ void __launch_bounds__(kPyrThreads)
pyramid_rgb8_kernel(const uint8_t* __restrict__ rgb, long long hw,
                    long long total, const float* __restrict__ consts,
                    float* __restrict__ lin, float* __restrict__ xyb) {
  __shared__ float lut[256];
  __shared__ float k[kMix];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = consts[kLut + i];
  for (int i = threadIdx.x; i < kMix; i += blockDim.x) k[i] = consts[kOpsin + i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < total; idx += stride) {
    const long long n = idx / hw, p = idx - n * hw;
    const uint8_t* px = rgb + 3 * idx;
    const float c[3] = {lut[px[0]], lut[px[1]], lut[px[2]]};
    float o[3];
    xyb_positive(c, k, o);
    const long long base = 3 * n * hw + p;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      lin[base + ch * hw] = c[ch];
      xyb[base + ch * hw] = o[ch];
    }
  }
}

// Further scales: lin (N, 3, h, w) -> 2x2 box with edge replication on odd
// sizes -> lin2, xyb2 (N, 3, ceil(h/2), ceil(w/2)).
__global__ void __launch_bounds__(kPyrThreads)
pyramid_down_kernel(const float* __restrict__ lin, int h, int w, int h2,
                    int w2, long long total, const float* __restrict__ consts,
                    float* __restrict__ lin2, float* __restrict__ xyb2) {
  __shared__ float k[kMix];
  for (int i = threadIdx.x; i < kMix; i += blockDim.x) k[i] = consts[kOpsin + i];
  __syncthreads();
  const long long hw = static_cast<long long>(h) * w;
  const long long hw2 = static_cast<long long>(h2) * w2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < total; idx += stride) {
    const long long n = idx / hw2, p = idx - n * hw2;
    const int oy = static_cast<int>(p / w2), ox = static_cast<int>(p - (p / w2) * w2);
    const int y0 = 2 * oy, x0 = 2 * ox;
    const int y1 = min(y0 + 1, h - 1), x1 = min(x0 + 1, w - 1);
    float c[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* src = lin + (3 * n + ch) * hw;
      const float top = __fadd_rn(src[static_cast<long long>(y0) * w + x0],
                                  src[static_cast<long long>(y0) * w + x1]);
      const float bot = __fadd_rn(src[static_cast<long long>(y1) * w + x0],
                                  src[static_cast<long long>(y1) * w + x1]);
      c[ch] = __fmul_rn(__fadd_rn(top, bot), 0.25f);
    }
    float o[3];
    xyb_positive(c, k, o);
    const long long base = 3 * n * hw2 + p;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      lin2[base + ch * hw2] = c[ch];
      xyb2[base + ch * hw2] = o[ch];
    }
  }
}

constexpr int kTile = 32;
constexpr int kHalo = 8;  // the largest radius the blur takes
constexpr int kSpan = kTile + 2 * kHalo;
constexpr int kBlurThreads = 256;

// One (32x32 tile, candidate, channel) per block. Reference side
// (kDist false): a = img1 -> out0 = blur(a), out1 = blur(a*a). Distorted
// side: a = img1 (batch stride ref_stride, 0 for a shared reference),
// b = img2 -> out0 = blur(b), out1 = blur(b*b), out2 = blur(a*b). Pixels
// outside the plane are zero (the reference's zero-padded convolutions);
// taps are summed from -radius to radius with one FMA each. With halo > 0
// the inputs are w + 2*halo wide (a width shard and its neighbours'
// columns, oavif_tpu/metric/sharded.py:67 _blur_sharded) and output column
// x is input column x + halo: for halo >= radius the horizontal pass
// reads no padding, and each output sums the taps of the single-device
// blur in the same order, so a shard's planes are that blur's columns
// bit for bit.
template <bool kDist>
__global__ void __launch_bounds__(kBlurThreads)
blur_kernel(const float* __restrict__ img1, long long ref_stride,
            const float* __restrict__ img2, int h, int w, int halo,
            const float* __restrict__ taps, int radius,
            float* __restrict__ out0, float* __restrict__ out1,
            float* __restrict__ out2) {
  constexpr int kIn = kDist ? 2 : 1;
  constexpr int kOut = kDist ? 3 : 2;
  __shared__ float in[kIn][kSpan][kSpan];
  __shared__ float hor[kOut][kSpan][kTile];
  __shared__ float k[2 * kHalo + 1];

  const int plane = blockIdx.z;  // n * 3 + channel
  const int n = plane / 3, c = plane - 3 * (plane / 3);
  const int win = w + 2 * halo;  // input columns
  const long long hw = static_cast<long long>(h) * w;
  const long long hw_in = static_cast<long long>(h) * win;
  const float* a = img1 + n * ref_stride + c * hw_in;
  const float* b = kDist ? img2 + plane * hw_in : nullptr;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;

  for (int i = tid; i <= 2 * radius; i += kBlurThreads) k[i] = taps[i];
  for (int i = tid; i < kSpan * kSpan; i += kBlurThreads) {
    const int r = i / kSpan, col = i - (i / kSpan) * kSpan;
    // output column gx reads input column gx + halo
    const int gy = y0 - kHalo + r, gx = x0 - kHalo + col + halo;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < win;
    const long long off = static_cast<long long>(gy) * win + gx;
    in[0][r][col] = inside ? a[off] : 0.0f;
    if constexpr (kDist) in[1][r][col] = inside ? b[off] : 0.0f;
  }
  __syncthreads();

  // horizontal pass over every row of the tile and its halo
  for (int i = tid; i < kSpan * kTile; i += kBlurThreads) {
    const int r = i / kTile, col = i - (i / kTile) * kTile;
    float acc[kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[o] = 0.0f;
    for (int t = -radius; t <= radius; ++t) {
      const float kt = k[t + radius];
      const float va = in[0][r][col + kHalo + t];
      if constexpr (kDist) {
        const float vb = in[1][r][col + kHalo + t];
        acc[0] = __fmaf_rn(kt, vb, acc[0]);
        acc[1] = __fmaf_rn(kt, __fmul_rn(vb, vb), acc[1]);
        acc[2] = __fmaf_rn(kt, __fmul_rn(va, vb), acc[2]);
      } else {
        acc[0] = __fmaf_rn(kt, va, acc[0]);
        acc[1] = __fmaf_rn(kt, __fmul_rn(va, va), acc[1]);
      }
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) hor[o][r][col] = acc[o];
  }
  __syncthreads();

  // vertical pass, written where the pixel lies inside the plane
  float* outs[3] = {out0, out1, out2};
  for (int i = tid; i < kTile * kTile; i += kBlurThreads) {
    const int r = i / kTile, col = i - (i / kTile) * kTile;
    const int gy = y0 + r, gx = x0 + col;
    if (gy >= h || gx >= w) continue;
    float acc[kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[o] = 0.0f;
    for (int t = -radius; t <= radius; ++t) {
      const float kt = k[t + radius];
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        acc[o] = __fmaf_rn(kt, hor[o][r + kHalo + t][col], acc[o]);
    }
    const long long off = plane * hw + static_cast<long long>(gy) * w + gx;
#pragma unroll
    for (int o = 0; o < kOut; ++o) outs[o][off] = acc[o];
  }
}

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;
constexpr int kSums = 6;

// Sums v[0..5] over the block in a fixed order; thread j < 6 returns the
// block's sum j in v[j] (other entries undefined).
__device__ __forceinline__ void block_sums(double v[kSums],
                                           double (*red)[kSums]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    double s = v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) red[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double s = 0.0;
    for (int i = 0; i < kNormWarps; ++i) s = __dadd_rn(s, red[i][threadIdx.x]);
    v[threadIdx.x] = s;
  }
}

// First pass: block (bx, plane) sums pixels [bx*chunk, (bx+1)*chunk) of one
// (candidate, channel) plane; partial[(plane * nblk + bx) * 6 + j].
__global__ void __launch_bounds__(kNormThreads)
norms_partial_kernel(const float* __restrict__ img1,
                     const float* __restrict__ mu1,
                     const float* __restrict__ s11, long long ref_stride,
                     const float* __restrict__ img2,
                     const float* __restrict__ mu2,
                     const float* __restrict__ s22,
                     const float* __restrict__ s12, long long hw,
                     long long chunk, float c2, double* __restrict__ partial) {
  __shared__ double red[kNormWarps][kSums];
  const int plane = blockIdx.y;
  const int n = plane / 3, c = plane - 3 * (plane / 3);
  const long long roff = n * ref_stride + c * hw, doff = plane * hw;
  const long long start = blockIdx.x * chunk;
  const long long end = start + chunk < hw ? start + chunk : hw;
  double v[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (long long p = start + threadIdx.x; p < end; p += kNormThreads) {
    const float m1 = mu1[roff + p], m2 = mu2[doff + p];
    const float mu11 = __fmul_rn(m1, m1), mu22 = __fmul_rn(m2, m2);
    const float mu12 = __fmul_rn(m1, m2);
    const float md = __fsub_rn(m1, m2);
    const float num_m = __fsub_rn(1.0f, __fmul_rn(md, md));
    const float num_s =
        __fadd_rn(__fmul_rn(2.0f, __fsub_rn(s12[doff + p], mu12)), c2);
    const float den_s = __fadd_rn(
        __fadd_rn(__fsub_rn(s11[roff + p], mu11), __fsub_rn(s22[doff + p], mu22)),
        c2);
    float d = __fsub_rn(1.0f, __fdiv_rn(__fmul_rn(num_m, num_s), den_s));
    d = d < 0.0f ? 0.0f : d;
    const float e1 = __fadd_rn(1.0f, fabsf(__fsub_rn(img1[roff + p], m1)));
    const float e2 = __fadd_rn(1.0f, fabsf(__fsub_rn(img2[doff + p], m2)));
    const float d1 = __fsub_rn(__fdiv_rn(e2, e1), 1.0f);
    const float art = d1 < 0.0f ? 0.0f : d1;
    const float det = -d1 < 0.0f ? 0.0f : -d1;
    const double x[3] = {d, art, det};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double sq = __dmul_rn(x[j], x[j]);
      v[j] = __dadd_rn(v[j], x[j]);
      v[3 + j] = __dadd_rn(v[3 + j], __dmul_rn(sq, sq));
    }
  }
  block_sums(v, red);
  if (threadIdx.x < kSums)
    partial[(static_cast<long long>(plane) * gridDim.x + blockIdx.x) * kSums +
            threadIdx.x] = v[threadIdx.x];
}

// Second pass: one block per plane folds its nblk partials, in order.
__global__ void __launch_bounds__(kNormThreads)
norms_fold_kernel(const double* __restrict__ partial, int nblk,
                  double* __restrict__ out) {
  __shared__ double red[kNormWarps][kSums];
  const long long base = static_cast<long long>(blockIdx.x) * nblk;
  double v[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < nblk; b += kNormThreads)
#pragma unroll
    for (int j = 0; j < kSums; ++j)
      v[j] = __dadd_rn(v[j], partial[(base + b) * kSums + j]);
  block_sums(v, red);
  if (threadIdx.x < kSums) out[blockIdx.x * kSums + threadIdx.x] = v[threadIdx.x];
}

constexpr int kIirThreads = 128;

// One step of the recursion, in the reference's operation order
// ((B*x + a1*y1) + a2*y2) + a3*y3, every product and sum rounded (no FMA).
__device__ __forceinline__ float yvv_step(const float* c, float x, float y1,
                                          float y2, float y3) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c[0], x), __fmul_rn(c[1], y1)),
                             __fmul_rn(c[2], y2)),
                   __fmul_rn(c[3], y3));
}

// W pass: one thread per (output o, candidate, channel, row). The input of
// output o is formed here: reference side a, a*a; distorted side b, b*b,
// a*b. Forward along the row into scratch, backward from the row's end
// into tmp; both (k, n, 3, h, w). Neighbouring threads walk neighbouring
// rows, so each access is a separate memory transaction (uncoalesced).
template <bool kDist>
__global__ void __launch_bounds__(kIirThreads)
iir_rows_kernel(const float* __restrict__ img1, long long ref_stride,
                const float* __restrict__ img2, int n, int h, int w,
                const float* __restrict__ coef, float* __restrict__ scratch,
                float* __restrict__ tmp) {
  constexpr int kOut = kDist ? 3 : 2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long per_out = 3LL * n * h;
  if (idx >= kOut * per_out) return;
  const int o = static_cast<int>(idx / per_out);
  const long long rem = idx - o * per_out;
  const int plane = static_cast<int>(rem / h), row = static_cast<int>(rem % h);
  const int nn = plane / 3, ch = plane - 3 * (plane / 3);
  const long long hw = static_cast<long long>(h) * w;
  const float* a = img1 + nn * ref_stride + ch * hw + static_cast<long long>(row) * w;
  const float* b = kDist ? img2 + plane * hw + static_cast<long long>(row) * w
                         : nullptr;
  const long long base = (static_cast<long long>(o) * 3 * n + plane) * hw +
                         static_cast<long long>(row) * w;
  float* s = scratch + base;
  float* t = tmp + base;
  const float c[4] = {coef[0], coef[1], coef[2], coef[3]};
  float y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
  for (int x = 0; x < w; ++x) {
    float v;
    if constexpr (kDist) {
      const float vb = b[x];
      v = o == 0 ? vb : (o == 1 ? __fmul_rn(vb, vb) : __fmul_rn(a[x], vb));
    } else {
      const float va = a[x];
      v = o == 0 ? va : __fmul_rn(va, va);
    }
    const float y = yvv_step(c, v, y1, y2, y3);
    y3 = y2;
    y2 = y1;
    y1 = y;
    s[x] = y;
  }
  y1 = y2 = y3 = 0.0f;
  for (int x = w - 1; x >= 0; --x) {
    const float y = yvv_step(c, s[x], y1, y2, y3);
    y3 = y2;
    y2 = y1;
    y1 = y;
    t[x] = y;
  }
}

// H pass: one thread per (output o, candidate, channel, column), walking
// down then up the column of tmp (neighbouring threads read neighbouring
// columns: coalesced), the forward pass into scratch, the backward pass
// into output o.
__global__ void __launch_bounds__(kIirThreads)
iir_cols_kernel(const float* __restrict__ tmp, int k, int n, int h, int w,
                const float* __restrict__ coef, float* __restrict__ scratch,
                float* __restrict__ out0, float* __restrict__ out1,
                float* __restrict__ out2) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long per_out = 3LL * n * w;
  if (idx >= k * per_out) return;
  const int o = static_cast<int>(idx / per_out);
  const long long rem = idx - o * per_out;
  const int plane = static_cast<int>(rem / w), col = static_cast<int>(rem % w);
  const long long hw = static_cast<long long>(h) * w;
  const long long base = (static_cast<long long>(o) * 3 * n + plane) * hw + col;
  const float* src = tmp + base;
  float* s = scratch + base;
  float* dst = (o == 0 ? out0 : (o == 1 ? out1 : out2)) + plane * hw + col;
  const float c[4] = {coef[0], coef[1], coef[2], coef[3]};
  float y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
  for (int y = 0; y < h; ++y) {
    const long long off = static_cast<long long>(y) * w;
    const float v = yvv_step(c, src[off], y1, y2, y3);
    y3 = y2;
    y2 = y1;
    y1 = v;
    s[off] = v;
  }
  y1 = y2 = y3 = 0.0f;
  for (int y = h - 1; y >= 0; --y) {
    const long long off = static_cast<long long>(y) * w;
    const float v = yvv_step(c, s[off], y1, y2, y3);
    y3 = y2;
    y2 = y1;
    y1 = v;
    dst[off] = v;
  }
}

int pyr_blocks(long long total) {
  const long long b = (total + kPyrThreads - 1) / kPyrThreads;
  return static_cast<int>(b < kPyrMaxBlocks ? b : kPyrMaxBlocks);
}

}  // namespace

// rgb (n, h, w, 3) uint8; consts: the 270 floats of _pyramid_consts;
// lin, xyb (n, 3, h, w) float32. Returns cudaGetLastError().
extern "C" int ssim2_pyramid_rgb8(const uint8_t* rgb, int n, int h, int w,
                                  const float* consts, float* lin, float* xyb,
                                  cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const long long hw = static_cast<long long>(h) * w, total = n * hw;
  pyramid_rgb8_kernel<<<pyr_blocks(total), kPyrThreads, 0, stream>>>(
      rgb, hw, total, consts, lin, xyb);
  return static_cast<int>(cudaGetLastError());
}

// lin (n, 3, h, w) -> lin2, xyb2 (n, 3, (h+1)/2, (w+1)/2), float32.
extern "C" int ssim2_pyramid_down(const float* lin, int n, int h, int w,
                                  const float* consts, float* lin2,
                                  float* xyb2, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  const long long total = static_cast<long long>(n) * h2 * w2;
  pyramid_down_kernel<<<pyr_blocks(total), kPyrThreads, 0, stream>>>(
      lin, h, w, h2, w2, total, consts, lin2, xyb2);
  return static_cast<int>(cudaGetLastError());
}

// Reference side (img2 == NULL): img1 (n, 3, h, w + 2*halo) -> out0 = mu1,
// out1 = s11, each (n, 3, h, w). Distorted side: img1 (n or 1, 3, h,
// w + 2*halo; ref_batched says which), img2 (n, 3, h, w + 2*halo) -> out0 =
// mu2, out1 = s22, out2 = s12. taps: 2*radius+1 floats, radius 0..8;
// halo 0..8.
extern "C" int ssim2_blur(const float* img1, int ref_batched,
                          const float* img2, int n, int h, int w, int halo,
                          const float* taps, int radius, float* out0,
                          float* out1, float* out2, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0 || 3LL * n > 65535 || radius < 0 ||
      radius > kHalo || halo < 0 || halo > kHalo)
    return cudaErrorInvalidValue;
  const long long hw_in = static_cast<long long>(h) * (w + 2 * halo);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, 3 * n);
  if (img2 == nullptr) {
    blur_kernel<false><<<grid, kBlurThreads, 0, stream>>>(
        img1, 3 * hw_in, nullptr, h, w, halo, taps, radius, out0, out1,
        nullptr);
  } else {
    blur_kernel<true><<<grid, kBlurThreads, 0, stream>>>(
        img1, ref_batched ? 3 * hw_in : 0, img2, h, w, halo, taps, radius,
        out0, out1, out2);
  }
  return static_cast<int>(cudaGetLastError());
}

// Recursive Gaussian (oavif_tpu/metric/ssimulacra2.py:309 blur_iir):
// along W, then along H, each a forward then a backward pass of the
// Young-van Vliet recursion y_t = B x_t + a1 y_(t-1) + a2 y_(t-2) +
// a3 y_(t-3) from a zero state. Reference side: src (n, 3, h, w) -> out0 =
// blur(a), out1 = blur(a*a); distorted side as ssim2_blur. scratch and
// tmp: k * n * 3 * h * w floats each (k = 2 or 3 outputs). coef: B, a1,
// a2, a3.
extern "C" int ssim2_blur_iir(const float* img1, int ref_batched,
                              const float* img2, int n, int h, int w,
                              const float* coef, float* scratch, float* tmp,
                              float* out0, float* out1, float* out2,
                              cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const long long hw = static_cast<long long>(h) * w;
  const int k = img2 == nullptr ? 2 : 3;
  const long long rows = static_cast<long long>(k) * 3 * n * h;
  const long long cols = static_cast<long long>(k) * 3 * n * w;
  if (rows > (1LL << 31) - 1 || cols > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  const int rb = static_cast<int>((rows + kIirThreads - 1) / kIirThreads);
  const int cb = static_cast<int>((cols + kIirThreads - 1) / kIirThreads);
  if (img2 == nullptr) {
    iir_rows_kernel<false><<<rb, kIirThreads, 0, stream>>>(
        img1, 3 * hw, nullptr, n, h, w, coef, scratch, tmp);
  } else {
    iir_rows_kernel<true><<<rb, kIirThreads, 0, stream>>>(
        img1, ref_batched ? 3 * hw : 0, img2, n, h, w, coef, scratch, tmp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  iir_cols_kernel<<<cb, kIirThreads, 0, stream>>>(tmp, k, n, h, w, coef,
                                                  scratch, out0, out1, out2);
  return static_cast<int>(cudaGetLastError());
}

// Sums over pixels per (candidate, channel) of the SSIM error map, the
// artifact map and the detail-lost map, and of their 4th powers: out
// (n, 3, 6) float64. Reference planes img1, mu1, s11 (n or 1, 3, h, w);
// candidate planes img2, mu2, s22, s12 (n, 3, h, w). partial: scratch of
// n * 3 * nblk * 6 doubles.
extern "C" int ssim2_norms(const float* img1, const float* mu1,
                           const float* s11, int ref_batched,
                           const float* img2, const float* mu2,
                           const float* s22, const float* s12, int n, int h,
                           int w, float c2, double* partial, int nblk,
                           double* out, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0 || nblk <= 0 || 3LL * n > 65535)
    return cudaErrorInvalidValue;
  const long long hw = static_cast<long long>(h) * w;
  const long long chunk = (hw + nblk - 1) / nblk;
  norms_partial_kernel<<<dim3(nblk, 3 * n), kNormThreads, 0, stream>>>(
      img1, mu1, s11, ref_batched ? 3 * hw : 0, img2, mu2, s22, s12, hw, chunk,
      c2, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norms_fold_kernel<<<3 * n, kNormThreads, 0, stream>>>(partial, nblk, out);
  return static_cast<int>(cudaGetLastError());
}
