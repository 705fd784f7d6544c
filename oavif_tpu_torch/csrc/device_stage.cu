// Device encode stage: open-loop 16x16 forward coefficients (K3a) and
// their round-half quantization at a batch of quantizers (K3b).
//
// K3a, dstage_coeffs16, replaces oavif_tpu/av1/device_stage.py
// _coeffs_body (jit :101): for every 16x16 luma block, the prediction of
// its PLANNED mode (one of DC, V, H, SMOOTH, PAETH, SMOOTH_V, SMOOTH_H)
// from source edges, the residual block - prediction, and the forward
// DCT16 fh @ R @ fw^T. The reference predicts all 7 modes into an
// (n, 7, 16, 16) stack and selects with a one-hot einsum; here each block
// is predicted under its one planned mode in exact integers, with its
// edges and fills from intra_edges.cuh (the planner's code), and each
// output of the two 16x16 products is summed in a fixed k order with
// __fmaf_rn. Nothing but the coefficients reaches global memory.
//
// coeffs16_kernel takes one thread block per strip of 16 blocks of a
// 16-row band. A thread first owns one column of one block: its 17
// source pixels in registers (every load in flight before the first
// store), its residual column under the block's mode (the mode a constant
// in each case of one switch), and that column of fh @ R; fh and fw travel
// in the launch's parameter block, so the matrix operand of every FMA
// comes from the constant bank, uniform across the warp. One transpose
// through shared memory (row stride 257, 1 mod 32: no bank conflicts
// either way), then the thread owns one row of t and computes that row of
// t @ fw^T, stored with four 16-byte writes. DC is a half-warp shuffle
// sum of the edges. About 2 shared accesses per output, against about 40
// in the first kernel, coeffs16_simple_kernel (one block per 16x16 block,
// both products out of shared memory), which the source keeps as the
// yardstick: every output keeps its two FMA chains, k order and operands,
// so the two give the same bits.
//
// K3b, dstage_quant16, replaces device_stage.py _quant_body (:83,
// vmapped over the quantizers, jit :102): the level is floor(|c| * up /
// dq + 0.5) with every operation rounded as in the plain version
// (__fmul_rn, __fdiv_rn, __fadd_rn: no contraction, IEEE division, no
// reciprocal), then the sign and the clip to +-16383; eob is the largest
// scan position + 1 over the nonzero levels. The reference's 256x256
// permutation matmul (a TPU workaround for gathers) becomes a read of the
// inverse scan table.
//
// quant16_kernel gives each 16-block one warp, four blocks a CTA (four
// rather than eight so that a 512x512 frame's 1,024 blocks still make 256
// CTAs for the 132 SMs). Lane l owns natural indices 8l..8l+7: two
// 16-byte loads of coefficients and two of their scan positions (the
// table stays in L1; in the constant bank the lanes' different addresses
// would serialise), issued before any store, so the warp reads its block
// in one coalesced 1 KB sweep and the coefficients are read ONCE however
// many quantizers there are. Per quantizer the lane quantizes its 8
// values in registers, stores them as one 16-byte word, and the block's
// eob is a 5-step warp-shuffle max of the lanes' maxima: no shared
// memory, no barrier. The first K3b kernel, quant16_simple_kernel (grid
// (blocks, quantizers), one thread per coefficient, the coefficients read
// again for every quantizer, eob through shared memory), is kept as the
// yardstick; both call quant_level, so they give the same bits.
//
// What bounds them on the H100: at 3840x2160 (31,680 blocks) K3a reads
// 16.2 MB of int16 plane and writes 32.4 MB of float32 coefficients
// against 0.26 G FMAs, and K3b reads the 32.4 MB of coefficients once and
// writes 16.2 MB of levels per quantizer: both are bound by HBM bytes
// (K3a 0.0146 ms at 3.35 TB/s; K3b 0.0146 ms at one quantizer, 0.0243 at
// three). Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, kernel
// alone by torch.profiler): coeffs16_kernel 0.036 ms,
// coeffs16_simple_kernel 0.089 ms; quant16_kernel 0.0186 ms at one
// quantizer, 0.0256 at two, 0.0328 at three (78%, 76% and 74% of the
// bound; 48 registers, no spills), against quant16_simple_kernel's
// 0.0377, 0.0733 and 0.1088 ms in the same run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC (oavif_tpu_torch/kernels/build.py).

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

#include "intra_edges.cuh"

namespace {

constexpr int kThreads = 256;  // one per pixel or coefficient of a block
constexpr int kWarps = kThreads / 32;
constexpr int kLevelMax = 16383;

constexpr int P = 16;          // the block's side
constexpr int L = 2 * P + 1;   // the edge vector's above or left half
constexpr int kStrip = kThreads / P;   // 16-blocks in coeffs16_kernel's strip
constexpr int kStageW = kStrip * P + 1;  // staged plane columns
constexpr int kTld = kStrip * P + 1;   // t's row stride: 257 = 1 mod 32

// The planned mode's prediction of pixel (r, c) from the block's filled
// edges, as the reference's integer-valued formulas
// (oavif_tpu_torch/av1/encode_tpu.py _predictions): a = above[c], l =
// left[r], cr the corner, below = left[P-1], right = above[P-1], wr and
// wc the smooth weights of r and c, dc the DC prediction.
__device__ __forceinline__ int predict(int mode, int a, int l, int cr,
                                       int below, int right, int wr, int wc,
                                       int dc) {
  switch (mode) {
    case 1:  // V
      return a;
    case 2:  // H
      return l;
    case 3:  // SMOOTH
      return (wr * a + (256 - wr) * below + wc * l + (256 - wc) * right +
              256) >> 9;
    case 4: {  // PAETH
      const int pa = abs(l - cr), pl = abs(a - cr), pc = abs(a + l - 2 * cr);
      return (pa <= pl && pa <= pc) ? a : (pl <= pc ? l : cr);
    }
    case 5:  // SMOOTH_V
      return (wr * a + (256 - wr) * below + 128) >> 8;
    case 6:  // SMOOTH_H
      return (wc * l + (256 - wc) * right + 128) >> 8;
    default:  // 0, DC (the host checks the range)
      return dc;
  }
}

// The first K3a kernel, kept as the yardstick that coeffs16_kernel must
// equal bit for bit: one 256-thread block per 16x16 block, both products
// out of shared memory.
__global__ void __launch_bounds__(kThreads)
coeffs16_simple_kernel(const int16_t* __restrict__ plane, int ld, int nbx,
                       int base, const int32_t* __restrict__ modes,
                       const int32_t* __restrict__ smw,
                       const float* __restrict__ fh,
                       const float* __restrict__ fw,
                       float* __restrict__ out) {
  __shared__ int edge[2 * L];
  __shared__ float fh_s[P][P];
  __shared__ float fw_s[P][P + 1];   // read by column: padded
  __shared__ float res_s[P][P];
  __shared__ float t_s[P][P];
  __shared__ int dc_s;

  const int blk = blockIdx.x;
  const int bi = blk / nbx, bj = blk - (blk / nbx) * nbx;
  const int tid = threadIdx.x;
  const int r = tid >> 4, c = tid & (P - 1);

  fh_s[r][c] = fh[tid];
  fw_s[r][c] = fw[tid];
  oavif::load_edges<P, kThreads>(plane, ld, bi, bj, base, edge);
  if (tid == 0) dc_s = oavif::dc_pred<P>(edge);
  __syncthreads();

  const int pred = predict(modes[blk], edge[1 + c], edge[L + 1 + r], edge[0],
                           edge[L + P], edge[P], smw[r], smw[c], dc_s);
  const int x = plane[(1 + bi * P + r) * ld + 1 + bj * P + c];
  res_s[r][c] = static_cast<float>(x - pred);  // exact
  __syncthreads();

  // t = fh @ res, then out = t @ fw^T, each sum in k order
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) acc = __fmaf_rn(fh_s[r][k], res_s[k][c], acc);
  t_s[r][c] = acc;
  __syncthreads();
  acc = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) acc = __fmaf_rn(t_s[r][k], fw_s[c][k], acc);
  out[static_cast<long long>(blk) * (P * P) + tid] = acc;
}

// The forward matrices and smooth weights, passed by value: the launch's
// parameter block lives in the constant bank, so every FMA below takes
// its matrix operand from there, uniform across the warp.
struct Coeffs16Consts {
  float fh[P * P];
  float fw[P * P];
  int smw[P];
};

// One block per strip of kStrip 16-blocks of a 16-row band. Thread
// (j, c) = (tid / 16, tid % 16): first block j's column c (prediction,
// residual and that column of fh @ R in registers), then, after one
// transpose through t_s, block j's row c (that row of t @ fw^T, stored
// with four 16-byte writes).
__global__ void __launch_bounds__(kThreads)
coeffs16_kernel(const int16_t* __restrict__ plane, int ld, int nbx,
                int base, const int32_t* __restrict__ modes,
                const __grid_constant__ Coeffs16Consts m,
                float* __restrict__ out) {
  __shared__ int16_t stage[(P + 1) * kStageW];
  __shared__ float t_s[P * kTld];

  const int bi = blockIdx.y, j0 = blockIdx.x * kStrip;
  const int tid = threadIdx.x;
  const int j = tid >> 4, c = tid & (P - 1);
  const int bj = j0 + j;
  const bool live = bj < nbx;
  // padded column 1 + tid of the band's rows bi*16 .. bi*16+16 in
  // registers (zeros past the last block), every load issued before the
  // first store; threads 0..16 also stage the strip's left column
  const int16_t* src = plane + static_cast<long long>(bi * P) * ld + j0 * P;
  int x[P + 1];
#pragma unroll
  for (int i = 0; i <= P; ++i)
    x[i] = live ? src[static_cast<long long>(i) * ld + 1 + tid] : 0;
  const int16_t left = tid <= P ? src[static_cast<long long>(tid) * ld] : 0;
#pragma unroll
  for (int i = 0; i <= P; ++i) stage[i * kStageW + 1 + tid] = x[i];
  if (tid <= P) stage[tid * kStageW] = left;
  __syncthreads();

  const bool row0 = bi == 0, col0 = bj == 0;
  const oavif::Pix pix{stage + j * P, kStageW};
  const int a = oavif::edge_at<P>(pix, row0, col0, base, 1 + c);
  const int cr = oavif::edge_at<P>(pix, row0, col0, base, 0);
  const int right = oavif::edge_at<P>(pix, row0, col0, base, P);
  const int below = oavif::edge_at<P>(pix, row0, col0, base, L + P);
  // DC: the half-warp of block j sums above[c] + left[c]
  int s = a + oavif::edge_at<P>(pix, row0, col0, base, L + 1 + c);
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  const int dc = (s + P) >> (oavif::Log2<P>::value + 1);
  const int wc = m.smw[c];

  // the residual column under the planned mode, the mode a constant in
  // each case so that predict() folds to its formula
  float res[P];
  auto residuals = [&](auto mode) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int l = oavif::edge_at<P>(pix, row0, col0, base, L + 1 + r);
      res[r] = static_cast<float>(
          x[1 + r] - predict(decltype(mode)::value, a, l, cr, below, right,
                             m.smw[r], wc, dc));
    }
  };
  switch (live ? modes[bi * nbx + bj] : 0) {
    case 1: residuals(std::integral_constant<int, 1>()); break;
    case 2: residuals(std::integral_constant<int, 2>()); break;
    case 3: residuals(std::integral_constant<int, 3>()); break;
    case 4: residuals(std::integral_constant<int, 4>()); break;
    case 5: residuals(std::integral_constant<int, 5>()); break;
    case 6: residuals(std::integral_constant<int, 6>()); break;
    default: residuals(std::integral_constant<int, 0>());
  }
  // column c of t = fh @ res, each sum in k order
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k) acc = __fmaf_rn(m.fh[r * P + k], res[k], acc);
    t_s[r * kTld + tid] = acc;
  }
  __syncthreads();

  // row c of block j: out = t @ fw^T, each sum in k order
  float t[P];
#pragma unroll
  for (int k = 0; k < P; ++k) t[k] = t_s[c * kTld + j * P + k];
  float o[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k) acc = __fmaf_rn(t[k], m.fw[q * P + k], acc);
    o[q] = acc;
  }
  if (live) {
    float4* dst = reinterpret_cast<float4*>(
        out + (static_cast<long long>(bi * nbx + bj) * P + c) * P);
#pragma unroll
    for (int v = 0; v < P / 4; ++v)
      dst[v] = make_float4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
  }
}

// One coefficient's level: floor(|c| * up / dq + 0.5) with every operation
// rounded as in the plain version (no contraction, IEEE division), then the
// sign and the clip to +-16383.
__device__ __forceinline__ int quant_level(float c, float up, float dq) {
  const float mag =
      floorf(__fadd_rn(__fdiv_rn(__fmul_rn(fabsf(c), up), dq), 0.5f));
  const float v = fminf(fmaxf(c < 0.0f ? -mag : mag,
                              static_cast<float>(-kLevelMax)),
                        static_cast<float>(kLevelMax));
  return static_cast<int>(v);
}

// The first K3b kernel, kept as the yardstick that quant16_kernel must
// equal bit for bit: grid (blocks, quantizers), one thread per coefficient,
// the coefficients read again for every quantizer, eob through one
// shared-memory step behind a barrier.
__global__ void __launch_bounds__(kThreads)
quant16_simple_kernel(const float* __restrict__ coeffs, int n,
                      const float* __restrict__ dq_dc,
                      const float* __restrict__ dq_ac, float up,
                      const int32_t* __restrict__ iscan,
                      int16_t* __restrict__ levels,
                      int32_t* __restrict__ eob) {
  __shared__ int red[kWarps];
  const int blk = blockIdx.x, q = blockIdx.y, tid = threadIdx.x;
  const long long row = static_cast<long long>(q) * n + blk;

  const float cf = coeffs[static_cast<long long>(blk) * kThreads + tid];
  const int lv = quant_level(cf, up, tid == 0 ? dq_dc[q] : dq_ac[q]);
  levels[row * kThreads + tid] = static_cast<int16_t>(lv);

  int e = lv != 0 ? iscan[tid] + 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    e = max(e, __shfl_xor_sync(0xffffffffu, e, off));
  if ((tid & 31) == 0) red[tid >> 5] = e;
  __syncthreads();
  if (tid == 0) {
    int m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = max(m, red[w]);
    eob[row] = m;
  }
}

constexpr int kQuantWarps = 4;  // 16-blocks (warps) per quant16_kernel CTA
constexpr int kLanePer = 256 / 32;  // coefficients per lane

// One warp per 16-block, kQuantWarps blocks a CTA. Lane l owns natural
// indices 8l..8l+7: two 16-byte coefficient loads and two of their scan
// positions, all issued before the first store. Then for each quantizer
// its 8 levels go out as one 16-byte store, and eob is a 5-step shuffle
// max of the lanes' own maxima: no shared memory, no barrier, and the
// coefficients are read once whatever k is.
__global__ void __launch_bounds__(kQuantWarps * 32)
quant16_kernel(const float* __restrict__ coeffs, int n, int k,
               const float* __restrict__ dq_dc,
               const float* __restrict__ dq_ac, float up,
               const int32_t* __restrict__ iscan,
               int16_t* __restrict__ levels, int32_t* __restrict__ eob) {
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (blk >= n) return;  // the whole warp: its shuffles stay full
  const float4* src = reinterpret_cast<const float4*>(
      coeffs + static_cast<long long>(blk) * 256) + 2 * lane;
  const int4* pos = reinterpret_cast<const int4*>(iscan) + 2 * lane;
  const float4 c0 = __ldg(src), c1 = __ldg(src + 1);
  const int4 p0 = __ldg(pos), p1 = __ldg(pos + 1);
  const float c[kLanePer] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const int sp[kLanePer] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};

  for (int q = 0; q < k; ++q) {
    const float dqa = __ldg(dq_ac + q);
    const float dq0 = lane == 0 ? __ldg(dq_dc + q) : dqa;  // index 0: DC
    int lv[kLanePer];
    int e = 0;
#pragma unroll
    for (int i = 0; i < kLanePer; ++i) {
      lv[i] = quant_level(c[i], up, i == 0 ? dq0 : dqa);
      e = lv[i] != 0 ? max(e, sp[i] + 1) : e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      e = max(e, __shfl_xor_sync(0xffffffffu, e, off));
    const long long row = static_cast<long long>(q) * n + blk;
    uint4 packed;
    packed.x = (lv[0] & 0xffff) | (static_cast<unsigned>(lv[1]) << 16);
    packed.y = (lv[2] & 0xffff) | (static_cast<unsigned>(lv[3]) << 16);
    packed.z = (lv[4] & 0xffff) | (static_cast<unsigned>(lv[5]) << 16);
    packed.w = (lv[6] & 0xffff) | (static_cast<unsigned>(lv[7]) << 16);
    reinterpret_cast<uint4*>(levels + row * 256)[lane] = packed;
    if (lane == 0) eob[row] = e;
  }
}

}  // namespace

// plane: (>= 16*nby+1, ld) int16, the (+1,+1)-padded plane, row stride ld.
// modes: (nby*nbx,) int32 mode indices 0..6. smw: (16,) int32 smooth
// weights and fh, fw: (16, 16) float32 forward matrices, all three in HOST
// memory (they travel in the launch's parameter block). out: (nby*nbx, 16,
// 16) float32, 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dstage_coeffs16(const int16_t* plane, int ld, int nby,
                               int nbx, int base, const int32_t* modes,
                               const int32_t* smw, const float* fh,
                               const float* fw, float* out,
                               cudaStream_t stream) {
  if (nby <= 0 || nbx <= 0 || nby > 65535) return cudaErrorInvalidValue;
  Coeffs16Consts m;
  std::memcpy(m.fh, fh, sizeof m.fh);
  std::memcpy(m.fw, fw, sizeof m.fw);
  std::memcpy(m.smw, smw, sizeof m.smw);
  const dim3 grid((nbx + kStrip - 1) / kStrip, nby);
  coeffs16_kernel<<<grid, kThreads, 0, stream>>>(plane, ld, nbx, base, modes,
                                                 m, out);
  return static_cast<int>(cudaGetLastError());
}

// The yardstick kernel: the arguments of dstage_coeffs16, with smw, fh and
// fw in DEVICE memory. On no path.
extern "C" int dstage_coeffs16_simple(const int16_t* plane, int ld, int nby,
                                      int nbx, int base,
                                      const int32_t* modes,
                                      const int32_t* smw, const float* fh,
                                      const float* fw, float* out,
                                      cudaStream_t stream) {
  if (nby <= 0 || nbx <= 0) return cudaErrorInvalidValue;
  coeffs16_simple_kernel<<<dim3(nby * nbx), kThreads, 0, stream>>>(
      plane, ld, nbx, base, modes, smw, fh, fw, out);
  return static_cast<int>(cudaGetLastError());
}

// coeffs: (n, 16, 16) float32, 16-byte aligned. dq_dc, dq_ac: (k,)
// float32. up: 2^shift. iscan: (256,) int32 scan position of each natural
// index, 16-byte aligned. levels: (k, n, 256) int16, natural order,
// 16-byte aligned. eob: (k, n) int32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dstage_quant16(const float* coeffs, int n, int k,
                              const float* dq_dc, const float* dq_ac,
                              float up, const int32_t* iscan,
                              int16_t* levels, int32_t* eob,
                              cudaStream_t stream) {
  if (n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const unsigned grid = (static_cast<unsigned>(n) + kQuantWarps - 1) /
                        kQuantWarps;
  quant16_kernel<<<grid, kQuantWarps * 32, 0, stream>>>(
      coeffs, n, k, dq_dc, dq_ac, up, iscan, levels, eob);
  return static_cast<int>(cudaGetLastError());
}

// The yardstick kernel: the arguments of dstage_quant16, without its
// alignment needs. On no path.
extern "C" int dstage_quant16_simple(const float* coeffs, int n, int k,
                                     const float* dq_dc, const float* dq_ac,
                                     float up, const int32_t* iscan,
                                     int16_t* levels, int32_t* eob,
                                     cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > 65535) return cudaErrorInvalidValue;
  quant16_simple_kernel<<<dim3(n, k), kThreads, 0, stream>>>(
      coeffs, n, dq_dc, dq_ac, up, iscan, levels, eob);
  return static_cast<int>(cudaGetLastError());
}
