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
//                  ssim2_blur_simple is the first blur kernel, kept as the
//                  exact yardstick that no path launches;
//   ssim2_blur_iir blur_iir (:309, _iir_pass_1d :287), the recursive
//                  Gaussian under OAVIF_METRIC_BLUR=iir;
//   ssim2_norms    _ssim_map_norms (:373) and _edge_diff_norms (:390);
//   ssim2_blur_norms  the candidates' side of one scale of _score_pair
//                  (:464, vmapped in _score_batch :502): the three blurs of
//                  ssim2_blur and the two norms of ssim2_norms in one pass,
//                  the score's launch per scale under the Gaussian (the
//                  pair stays for the reference side, the recursive blur
//                  and the width shards of metric/sharded.py).
// The feature assembly and the final nonlinearity stay in torch
// (oavif_tpu_torch/metric/ssimulacra2.py), as does every plain version.
//
// What bounds them on the H100, and what the design does about it. There
// is no matrix product here, so no tensor cores, wgmma or TMA (whose
// tensor maps are built on the host per tensor, while most launches are
// at 512x512 and below, where the launch rules).
//   - The pyramid and the norms are elementwise: a few tens of float32
//     operations per byte-moved pixel, bound by device memory. The pyramid
//     reads each byte or pixel once and writes linear RGB and XYB in the
//     same pass, sRGB decoded through a 256-entry table; the norms read
//     the seven planes once and keep the three maps in registers: only 6
//     float64 partial sums per block reach memory.
//   - The Gaussian blur moves 17 bytes per pixel and candidate (a, b in;
//     three maps out) for 3 maps x 2 passes x 17 fused multiply-adds: by
//     bytes its bound is device memory. The first kernel
//     (blur_simple_kernel, one output per thread and pass from a 32x32
//     tile) never came near it: about 145 shared-memory loads per output
//     pixel (two inputs and a tap per tap across, three maps and a tap per
//     tap down, over 1.5 rows per output row), a 48x48 span staged per
//     32x32 tile with 4-byte loads and a division per element, a run-time
//     radius that kept both tap loops rolled. On an NVIDIA H100 80GB HBM3
//     at 700 W (as every time in this note), at 3840x2160x4, distorted
//     side, it takes 2.35 ms; with one tap (radius 0) still 1.03 ms, so staging
//     and stores alone cost 44% and each pair of taps 0.08 ms.
//     blur_kernel keeps the arithmetic and changes the schedule:
//       * the radius is a template argument and the taps live in
//         registers, so both tap loops unroll;
//       * register tiling: across, a thread reads a window of 4 + 2R
//         staged values once as float4s and slides the taps over it;
//         down, a thread streams 8 + 2R filtered values of a column
//         through 8 accumulators. About 19 shared-memory values in 12
//         loads per output pixel, the products formed once per
//         window value;
//       * a block marches down a strip of 64 columns, 16 rows a step, and
//         keeps the last 32 filtered rows in a ring in shared memory, so a
//         row is filtered across once per 128-row segment (1.125x) and not
//         once per tile (1.5x at 32 rows): 108 multiply-adds per pixel and
//         candidate against a floor of 102;
//       * the next step's rows arrive by cp.async (16 bytes a copy, two
//         buffers) while the current ones are filtered, so device memory
//         streams through the compute; 45 KB of shared memory and at most
//         64 registers let four blocks share an SM.
//     The other way to filter fewer rows twice, a taller tile (64x64
//     outputs staged whole, filtered, then stored), was tried first and
//     took 1.33-1.37 ms: two 110 KB blocks to an SM, whose loads and
//     arithmetic take turns. The marching strip takes 0.88-0.90 ms (of
//     the other strips timed, two blocks to an SM instead of four cost
//     0.2 ms; 128 columns, 32 rows a step or 512-row segments gained
//     nothing). At radius 0 it takes 0.71-0.75 ms, the cost of moving the
//     bytes alone; the bytes bound is 0.51 ms.
//   - The recursive blur is a chain: each output depends on the one
//     before it along the axis, so one thread walks one row (W pass) or
//     one column (H pass), about four dependent float32 operations a step.
//     With every row and column resident at once the chains cost well
//     under a millisecond; the time is device memory. The kernel keeps the
//     reference's order of operations (which is what makes it equal its
//     plain version bit for bit), and the backward pass of an axis starts
//     where its forward pass ends, so this design goes through device
//     memory eight times per output element: 9.55 GB at 3840x2160x4 on the
//     distorted side, 2.85 ms at the memory rate, where reading the inputs
//     and writing the outputs once (the bound) is 0.51 ms. So every trip
//     has to be a coalesced one. A thread
//     that walks its row straight from memory touches 32 sectors per warp
//     for 128 useful bytes at every step (a W pass written so took
//     12.7-14.2 ms); instead a warp owns 32 rows and moves them through a
//     [32][33] tile of shared memory, 32 columns at a time: every load and
//     store is a row's 128 contiguous bytes, and the next chunk's loads are
//     in flight while the chain runs. The two
//     intermediates are the kernel's own, so they are stored as 32x32
//     tiles: the W pass writes and reads 4 KB at a stretch and the H pass
//     reads consecutive rows back to back (against row-major
//     intermediates the W pass fell from 3.37 to 2.67 ms and the H pass
//     from 2.23 to 1.97 ms). The H pass was coalesced from the start; it
//     issues the loads of 8 rows ahead of their steps. 4.5-4.7 ms in all.
//   - The score of a candidate batch (K2d) ran the distorted side of each
//     scale as the blur, which wrote mu2, s22 and s12 (12 bytes per
//     candidate pixel), then the norms, which read them back with img1,
//     mu1, s11 and img2: 3.58 GB at 3840x2160x4, scale 0, 1.905 ms of the
//     two kernels' device time. blur_sums_kernel is the blur's march with
//     another vertical pass: each thread keeps its outputs of the three
//     maps in registers and forms the norms there (add_norms, the same
//     float32 expressions), so the maps never reach memory. It reads img2
//     once, img1 and b's centre values from its own staging (b through a
//     fourth ring map, since a row's staging buffer is refilled before its
//     outputs are filtered down), and mu1, s11 and img1 at the outputs
//     from device memory. The bound reads img1, mu1, s11 and img2 once
//     (0.70 GB, 0.21 ms) against 246 float32 operations per element (0.37
//     ms): operations bound it. What the design does about it: one pass
//     over the maps' registers with every thread in the vertical pass (4
//     rows a thread, 64 registers, four blocks to an SM), and the
//     candidates of one strip and segment next to each other in the grid,
//     so that a shared reference's three planes come from L2 for all but
//     the first candidate.
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

#include <atomic>
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

constexpr int kMaxRadius = 8;  // the largest radius (and halo) the blur takes
constexpr int kBlurThreads = 256;
constexpr int kBlurWarps = kBlurThreads / 32;
constexpr int kRun = 4;  // outputs of one row per thread, horizontal pass

// Asynchronous copies from device memory into shared memory (LDGSTS): the
// copy needs no register and no further work once issued, so a block keeps
// its next rows in flight while it filters the current ones. An invalid
// copy reads nothing and fills its bytes with zeros (src must still be an
// address of the plane). The 16-byte form goes around L1.
__device__ __forceinline__ void cp_async_16(float* smem, const float* src,
                                            bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* smem, const float* src,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The blur's strip (see the note at the top for the measurements behind
// it): a block owns kStripW output columns and marches down a segment of
// kSegRows rows of them, kStepRows rows to a step, kDownRows output rows
// per thread in the vertical pass, with at most 64 registers so that
// kBlurBlocks blocks share an SM.
constexpr int kStripW = 64, kStepRows = 16, kDownRows = 8, kBlurBlocks = 4;
constexpr int kSegRows = 128;
static_assert(kStripW % 32 == 0 && kStripW % kRun == 0 &&
                  kStepRows % kDownRows == 0,
              "strip");

// The strip at radius R. A staged row spans kColHalo columns left and
// right: R rounded up to a multiple of 4, so that 16-byte copies stay
// aligned. The ring holds the last kStepRows + 2R horizontally filtered
// rows.
template <int R>
struct BlurStrip {
  static constexpr int kColHalo = (R + 3) & ~3;
  static constexpr int kSpanW = kStripW + 2 * kColHalo;  // staged columns
  static constexpr int kRing = kStepRows + 2 * R;        // filtered rows kept
  // a thread's window starts at its first output's staged column, which
  // is kLead columns before the first tap: its float4s
  static constexpr int kLead = kColHalo - R;
  static constexpr int kWin4 = (kLead + kRun + 2 * R + 3) / 4;
  static constexpr size_t bytes(int n_in, int n_out) {
    return sizeof(float) *
           (static_cast<size_t>(2) * n_in * kStepRows * kSpanW +
            static_cast<size_t>(n_out) * kRing * kStripW);
  }
};

// The march of one (strip of kStripW columns, segment of kSegRows rows,
// candidate, channel) block, shared by blur_kernel and blur_sums_kernel.
// Reference side (kDist false): a = the reference plane -> map 0 = a, map
// 1 = a*a. Distorted side: a = the reference plane, b = the candidate's ->
// map 0 = b, map 1 = b*b, map 2 = a*b. Pixels outside the plane are zero
// (the reference's zero-padded convolutions). With halo > 0 the inputs are
// win = w + 2*halo wide (a width shard and its neighbours' columns,
// oavif_tpu/metric/sharded.py:67 _blur_sharded) and output column x is
// input column x + halo: for halo >= radius the horizontal pass reads no
// padding.
//
// The arithmetic of every output is that of blur_simple_kernel below,
// operation for operation: acc = 0, then acc = fma(k[t], v[x + t], acc)
// for t = -R..R along the row, then the same chain down the column over
// the filtered rows; the products are __fmul_rn(b, b) and __fmul_rn(a, b).
// So the kernels give the same bits, and a shard's planes are the
// single-device blur's columns bit for bit.
//
// The block filters rows ys-R .. ye+R-1 across, kStepRows at a step, into
// a ring of kStepRows + 2R rows in shared memory, and after each step
// filters down the kStepRows output rows whose last row has just arrived,
// so a row is filtered across once per segment and not once per tile. Per
// step:
//   stage   the next step's input rows start their way into the other
//           half of a double buffer (cp.async, a warp to a row, 16 bytes a
//           copy when vec: every row start and the span's first column
//           16-byte aligned; else 4 bytes), then the block waits for this
//           step's rows, which were started a step ago, and meets;
//   across  each thread reads the window of kRun + 2R staged values of one
//           row once, as float4s (a quarter-warp reads 128 contiguous
//           bytes: no bank conflict), forms the products once per window
//           value, slides the unrolled taps over it in registers and
//           writes kRun values of each map into the ring (with kRaw, also
//           b itself at those columns, into ring map 3: the down pass
//           reads a candidate pixel R rows after its row was staged, when
//           its staging buffer has been refilled); the block meets;
//   down    down(hor, base, ob): the caller's vertical pass over the ring
//           hor ([maps][kRing][kStripW]; the step's first filtered row in
//           slot base) for the kStepRows output rows from ob, whose
//           windows end in this step's rows. Output row o's window starts
//           at ring row o - ys, counted from the segment's first filtered
//           row, which is slot base + kStepRows for row ob.
// The taps k are in registers; R is a template argument, so the tap loops
// unroll.
template <bool kDist, bool kRaw, int R, class Down>
__device__ __forceinline__ void blur_march(
    const float* __restrict__ a, const float* __restrict__ b, int h, int win,
    int halo, int x0, int ys, int ye, int tw, int vec,
    const float (&k)[2 * R + 1], Down down) {
  using T = BlurStrip<R>;
  constexpr int TW = kStripW, RB = kStepRows;
  constexpr int kIn = kDist ? 2 : 1;
  constexpr int kOut = kDist ? 3 : 2;
  constexpr int kTaps = 2 * R + 1;
  constexpr int SW = T::kSpanW, kRing = T::kRing;
  constexpr int kStage = kIn * RB * SW;  // floats of one staging buffer
  static_assert(kDist || !kRaw, "the raw copy is of the candidate plane");
  extern __shared__ float4 blur_smem[];
  float* stage = reinterpret_cast<float*>(blur_smem);  // [2][kIn][RB][SW]
  float* hor = stage + 2 * kStage;  // [kOut + kRaw][kRing][TW]
  const int steps = (ye - ys + 2 * R + RB - 1) / RB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // staged column 0 is input column gx0 (output column x reads input
  // column x + halo); step s stages rows ys - R + s*RB .. + RB - 1
  const int gx0 = x0 - T::kColHalo + halo;
  auto stage_rows = [&](int step) {
    float* buf = stage + (step & 1) * kStage;
#pragma unroll
    for (int r = warp; r < RB; r += kBlurWarps) {
      const int gy = ys - R + step * RB + r;
      const bool row_in = gy >= 0 && gy < h;
      const long long row_off = static_cast<long long>(gy) * win;
      if (vec) {
        // gx0 and win are multiples of 4: a float4 lies inside or outside
        for (int q = lane; q < SW / 4; q += 32) {
          const int gx = gx0 + 4 * q;
          const bool inside = row_in && gx >= 0 && gx < win;
          const long long off = inside ? row_off + gx : 0;
          cp_async_16(buf + r * SW + 4 * q, a + off, inside);
          if constexpr (kDist)
            cp_async_16(buf + (RB + r) * SW + 4 * q, b + off, inside);
        }
      } else {
        for (int col = lane; col < SW; col += 32) {
          const int gx = gx0 + col;
          const bool inside = row_in && gx >= 0 && gx < win;
          const long long off = inside ? row_off + gx : 0;
          cp_async_4(buf + r * SW + col, a + off, inside);
          if constexpr (kDist)
            cp_async_4(buf + (RB + r) * SW + col, b + off, inside);
        }
      }
    }
    cp_async_commit();
  };

  constexpr int kSegs = TW / kRun;
  constexpr int kWin = 4 * T::kWin4;
  const int segs = (tw + kRun - 1) / kRun;
  int base = 0;  // ring slot of the step's first filtered row
  stage_rows(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      stage_rows(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // every thread's copies of this step have landed, and the last step's
    // down pass has let go of the ring slots this step overwrites
    __syncthreads();
    const float* buf = stage + (step & 1) * kStage;

    // across: kRun outputs of one row per thread
    for (int task = tid; task < RB * kSegs; task += kBlurThreads) {
      const int r = task / kSegs, s = task - r * kSegs;
      if (s >= segs) continue;
      float v0[kWin], v1[kWin], v2[kWin];  // the maps' window values
#pragma unroll
      for (int q = 0; q < T::kWin4; ++q) {
        const float4 pa =
            reinterpret_cast<const float4*>(buf + r * SW + kRun * s)[q];
        const float va[4] = {pa.x, pa.y, pa.z, pa.w};
        if constexpr (kDist) {
          const float4 pb = reinterpret_cast<const float4*>(
              buf + (RB + r) * SW + kRun * s)[q];
          const float vb[4] = {pb.x, pb.y, pb.z, pb.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v0[4 * q + e] = vb[e];
            v1[4 * q + e] = __fmul_rn(vb[e], vb[e]);
            v2[4 * q + e] = __fmul_rn(va[e], vb[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v0[4 * q + e] = va[e];
            v1[4 * q + e] = __fmul_rn(va[e], va[e]);
            v2[4 * q + e] = 0.0f;
          }
        }
      }
      float acc[kOut][kRun];
#pragma unroll
      for (int o = 0; o < kOut; ++o)
#pragma unroll
        for (int j = 0; j < kRun; ++j) acc[o][j] = 0.0f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          acc[0][j] = __fmaf_rn(k[t], v0[T::kLead + j + t], acc[0][j]);
          acc[1][j] = __fmaf_rn(k[t], v1[T::kLead + j + t], acc[1][j]);
          if constexpr (kDist)
            acc[2][j] = __fmaf_rn(k[t], v2[T::kLead + j + t], acc[2][j]);
        }
      }
      int slot = base + r;
      if (slot >= kRing) slot -= kRing;
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        reinterpret_cast<float4*>(hor + (o * kRing + slot) * TW)[s] =
            make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
      if constexpr (kRaw) {
        // b at the thread's output columns: window values kLead + R + j
        constexpr int c0 = T::kLead + R;
        reinterpret_cast<float4*>(hor + (kOut * kRing + slot) * TW)[s] =
            make_float4(v0[c0], v0[c0 + 1], v0[c0 + 2], v0[c0 + 3]);
      }
    }
    __syncthreads();

    down(static_cast<const float*>(hor), base, ys - 2 * R + step * RB);
    base += RB;
    if (base >= kRing) base -= kRing;
  }
}

// blur_march with the blur's own vertical pass: the maps' values at each
// output pixel go to out0, out1 (and out2) (n, 3, h, w). Each thread
// streams kDownRows + 2R ring values of one column through kDownRows
// accumulators, each value read once, and stores its outputs (a warp
// writes 128 contiguous bytes per row) where the pixel lies inside the
// segment. Ring row i of a thread's window feeds output j with tap i - j,
// so each output still sums its taps from -R to R in order. img1 has batch
// stride ref_stride (0 for a shared reference).
template <bool kDist, int R>
__global__ void __launch_bounds__(kBlurThreads, kBlurBlocks)
blur_kernel(const float* __restrict__ img1, long long ref_stride,
            const float* __restrict__ img2, int h, int w, int halo,
            const float* __restrict__ taps, int vec,
            float* __restrict__ out0, float* __restrict__ out1,
            float* __restrict__ out2) {
  using T = BlurStrip<R>;
  constexpr int TW = kStripW, RB = kStepRows, kRows = kDownRows;
  constexpr int kOut = kDist ? 3 : 2;
  constexpr int kTaps = 2 * R + 1;
  constexpr int kRing = T::kRing;

  float k[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) k[i] = __ldg(taps + i);

  const int plane = blockIdx.z;  // n * 3 + channel
  const int n = plane / 3, c = plane - 3 * (plane / 3);
  const int win = w + 2 * halo;  // input columns
  const long long hw = static_cast<long long>(h) * w;
  const long long hw_in = static_cast<long long>(h) * win;
  const float* a = img1 + n * ref_stride + c * hw_in;
  const float* b = kDist ? img2 + plane * hw_in : nullptr;
  const int x0 = blockIdx.x * TW;
  const int ys = blockIdx.y * kSegRows, ye = min(h, ys + kSegRows);
  const int tw = min(TW, w - x0);  // columns inside the plane
  const int tid = threadIdx.x;
  float* outs[3] = {out0, out1, out2};

  blur_march<kDist, false, R>(
      a, b, h, win, halo, x0, ys, ye, tw, vec, k,
      [&](const float* hor, int base, int ob) {
        if (ob + RB <= ys) return;
        for (int task = tid; task < (RB / kRows) * TW;
             task += kBlurThreads) {
          const int g = task / TW, col = task - g * TW;
          const int oy = ob + g * kRows;
          if (col >= tw || oy + kRows <= ys || oy >= ye) continue;
          const int slot0 = (base + RB + g * kRows) % kRing;
          const long long off = plane * hw + static_cast<long long>(oy) * w +
                                x0 + col;
#pragma unroll
          for (int o = 0; o < kOut; ++o) {
            const float* hp = hor + o * kRing * TW + col;
            float acc[kRows];
#pragma unroll
            for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
            int slot = slot0;
#pragma unroll
            for (int i = 0; i < kRows + 2 * R; ++i) {
              const float v = hp[slot * TW];
              if (++slot == kRing) slot = 0;
#pragma unroll
              for (int j = 0; j < kRows; ++j)
                if (i - j >= 0 && i - j < kTaps)
                  acc[j] = __fmaf_rn(k[i - j], v, acc[j]);
            }
#pragma unroll
            for (int j = 0; j < kRows; ++j)
              if (oy + j >= ys && oy + j < ye)
                outs[o][off + static_cast<long long>(j) * w] = acc[j];
          }
        }
      });
}

template <bool kDist, int R>
cudaError_t launch_blur(const float* img1, long long ref_stride,
                        const float* img2, int n, int h, int w, int halo,
                        const float* taps, int vec, float* out0, float* out1,
                        float* out2, cudaStream_t stream) {
  auto kernel = blur_kernel<kDist, R>;
  constexpr size_t smem = BlurStrip<R>::bytes(kDist ? 2 : 1, kDist ? 3 : 2);
  // 45 KB at most with the strip above, which a launch may simply ask for
  static_assert(smem <= 48 * 1024,
                "a larger strip has to raise the kernel's limit first");
  const dim3 grid((w + kStripW - 1) / kStripW, (h + kSegRows - 1) / kSegRows,
                  3 * n);
  kernel<<<grid, kBlurThreads, smem, stream>>>(img1, ref_stride, img2, h, w,
                                               halo, taps, vec, out0, out1,
                                               out2);
  return cudaGetLastError();
}

template <bool kDist, int R = kMaxRadius>
cudaError_t dispatch_blur(int radius, const float* img1, long long ref_stride,
                          const float* img2, int n, int h, int w, int halo,
                          const float* taps, int vec, float* out0,
                          float* out1, float* out2, cudaStream_t stream) {
  if (radius == R)
    return launch_blur<kDist, R>(img1, ref_stride, img2, n, h, w, halo, taps,
                                 vec, out0, out1, out2, stream);
  if constexpr (R > 0)
    return dispatch_blur<kDist, R - 1>(radius, img1, ref_stride, img2, n, h,
                                       w, halo, taps, vec, out0, out1, out2,
                                       stream);
  return cudaErrorInvalidValue;
}

// The first blur kernel, kept as the exact yardstick of blur_kernel (the
// same arithmetic per output, the simplest schedule): one 32x32 tile per
// block with an 8-pixel halo in shared memory, one output per thread and
// pass, the radius and the taps read at run time. Nothing on a path
// launches it.
constexpr int kSimpleTile = 32;
constexpr int kSimpleSpan = kSimpleTile + 2 * kMaxRadius;

template <bool kDist>
__global__ void __launch_bounds__(kBlurThreads)
blur_simple_kernel(const float* __restrict__ img1, long long ref_stride,
                   const float* __restrict__ img2, int h, int w, int halo,
                   const float* __restrict__ taps, int radius,
                   float* __restrict__ out0, float* __restrict__ out1,
                   float* __restrict__ out2) {
  constexpr int kIn = kDist ? 2 : 1;
  constexpr int kOut = kDist ? 3 : 2;
  constexpr int kTile = kSimpleTile, kHalo = kMaxRadius, kSpan = kSimpleSpan;
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
// block's sum j (the others 0). No array is indexed by the thread, so v
// stays in registers.
__device__ __forceinline__ double block_sums(const double v[kSums],
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
  double s = 0.0;
  if (threadIdx.x < kSums)
    for (int i = 0; i < kNormWarps; ++i) s = __dadd_rn(s, red[i][threadIdx.x]);
  return s;
}

// One pixel of the SSIM error map d, the artifact map and the detail-lost
// map (the plain version's float32 roundings), added with their 4th powers
// to v in float64. i1, m1, q11: img1, mu1, s11; i2, m2, q22, q12: img2,
// mu2, s22, s12.
__device__ __forceinline__ void add_norms(float i1, float m1, float q11,
                                          float i2, float m2, float q22,
                                          float q12, float c2,
                                          double v[kSums]) {
  const float mu11 = __fmul_rn(m1, m1), mu22 = __fmul_rn(m2, m2);
  const float mu12 = __fmul_rn(m1, m2);
  const float md = __fsub_rn(m1, m2);
  const float num_m = __fsub_rn(1.0f, __fmul_rn(md, md));
  const float num_s = __fadd_rn(__fmul_rn(2.0f, __fsub_rn(q12, mu12)), c2);
  const float den_s =
      __fadd_rn(__fadd_rn(__fsub_rn(q11, mu11), __fsub_rn(q22, mu22)), c2);
  float d = __fsub_rn(1.0f, __fdiv_rn(__fmul_rn(num_m, num_s), den_s));
  d = d < 0.0f ? 0.0f : d;
  const float e1 = __fadd_rn(1.0f, fabsf(__fsub_rn(i1, m1)));
  const float e2 = __fadd_rn(1.0f, fabsf(__fsub_rn(i2, m2)));
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
  for (long long p = start + threadIdx.x; p < end; p += kNormThreads)
    add_norms(img1[roff + p], mu1[roff + p], s11[roff + p], img2[doff + p],
              mu2[doff + p], s22[doff + p], s12[doff + p], c2, v);
  const double sum = block_sums(v, red);
  if (threadIdx.x < kSums)
    partial[(static_cast<long long>(plane) * gridDim.x + blockIdx.x) * kSums +
            threadIdx.x] = sum;
}

// Second pass: one block per plane folds its nblk partials, in order.
__device__ __forceinline__ void fold_partials(const double* __restrict__ partial,
                                              int nblk,
                                              double* __restrict__ out) {
  __shared__ double red[kNormWarps][kSums];
  const long long base = static_cast<long long>(blockIdx.x) * nblk;
  double v[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < nblk; b += kNormThreads)
#pragma unroll
    for (int j = 0; j < kSums; ++j)
      v[j] = __dadd_rn(v[j], partial[(base + b) * kSums + j]);
  const double sum = block_sums(v, red);
  if (threadIdx.x < kSums) out[blockIdx.x * kSums + threadIdx.x] = sum;
}

__global__ void __launch_bounds__(kNormThreads)
norms_fold_kernel(const double* __restrict__ partial, int nblk,
                  double* __restrict__ out) {
  fold_partials(partial, nblk, out);
}

// The distorted side's blur and the norms in one pass (K2d's per-scale
// work without its three intermediate maps; see the note at the top):
// blur_march on the candidates with the raw copy of b, whose vertical
// pass keeps each thread's kSumRows outputs of the three maps in
// registers, reads img1, mu1 and s11 at those pixels from device memory
// and b from ring map 3, and adds each pixel to the thread's six float64
// sums (add_norms). The block then reduces them (block_sums) into one
// partial per (plane, strip, segment): partial[(plane * nblk + by * gx +
// bx) * 6 + j], nblk = gx * gy, which blur_sums_fold_kernel folds in
// order.
// kSumRows = 4 gives each of the 256 threads one column of 4 rows a step;
// with four blocks to an SM that fits 64 registers without a spill. Of the
// shapes timed at 3840x2160x4 (NVIDIA H100 80GB HBM3, 700 W), it was the
// fastest at 1.11 ms; 4 rows and three blocks (72 registers) took 1.15
// ms, 2 rows 1.25 ms, 8 rows (the blur's; half the threads idle in the
// vertical pass) 1.15-1.19 ms at three blocks, with a spill at radius 0,
// and 1.52 ms at two. A grid ordered candidate-fastest, so that a shared
// reference's planes come from L2 for all but the first candidate, gained
// nothing (1.111-1.113 ms against 1.110-1.114 in one call).
constexpr int kSumRows = 4, kSumBlocks = 4;
static_assert(kStepRows % kSumRows == 0, "whole tasks");

template <int R>
__global__ void __launch_bounds__(kBlurThreads, kSumBlocks)
blur_sums_kernel(const float* __restrict__ img1,
                 const float* __restrict__ mu1,
                 const float* __restrict__ s11, long long ref_stride,
                 const float* __restrict__ img2, int h, int w,
                 const float* __restrict__ taps, int vec, float c2,
                 double* __restrict__ partial) {
  using T = BlurStrip<R>;
  constexpr int TW = kStripW, RB = kStepRows, kRows = kSumRows;
  constexpr int kTaps = 2 * R + 1;
  constexpr int kRing = T::kRing;
  __shared__ double red[kNormWarps][kSums];

  float k[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) k[i] = __ldg(taps + i);

  const int plane = blockIdx.z;  // n * 3 + channel
  const int n = plane / 3, c = plane - 3 * (plane / 3);
  const long long hw = static_cast<long long>(h) * w;
  const long long roff = n * ref_stride + c * hw;
  const float* a = img1 + roff;
  const float* b = img2 + plane * hw;
  const int x0 = blockIdx.x * TW;
  const int ys = blockIdx.y * kSegRows, ye = min(h, ys + kSegRows);
  const int tw = min(TW, w - x0);  // columns inside the plane
  const int tid = threadIdx.x;
  double v[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};

  blur_march<true, true, R>(
      a, b, h, w, 0, x0, ys, ye, tw, vec, k,
      [&](const float* hor, int base, int ob) {
        if (ob + RB <= ys) return;
        for (int task = tid; task < (RB / kRows) * TW;
             task += kBlurThreads) {
          const int g = task / TW, col = task - g * TW;
          const int oy = ob + g * kRows;
          if (col >= tw || oy + kRows <= ys || oy >= ye) continue;
          // the reference's planes at the outputs, loaded ahead of the
          // vertical pass
          float r1[kRows], rm[kRows], rs[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const long long p =
                static_cast<long long>(oy + j) * w + x0 + col;
            const bool in = oy + j >= ys && oy + j < ye;
            r1[j] = in ? a[p] : 0.0f;
            rm[j] = in ? mu1[roff + p] : 0.0f;
            rs[j] = in ? s11[roff + p] : 0.0f;
          }
          const int slot0 = (base + RB + g * kRows) % kRing;
          float m[3][kRows];  // mu2, s22, s12 at the thread's outputs
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            const float* hp = hor + o * kRing * TW + col;
#pragma unroll
            for (int j = 0; j < kRows; ++j) m[o][j] = 0.0f;
            int slot = slot0;
#pragma unroll
            for (int i = 0; i < kRows + 2 * R; ++i) {
              const float val = hp[slot * TW];
              if (++slot == kRing) slot = 0;
#pragma unroll
              for (int j = 0; j < kRows; ++j)
                if (i - j >= 0 && i - j < kTaps)
                  m[o][j] = __fmaf_rn(k[i - j], val, m[o][j]);
            }
          }
          const float* raw = hor + 3 * kRing * TW + col;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (oy + j < ys || oy + j >= ye) continue;
            int slot = slot0 + j + R;  // the centre row of output j
            if (slot >= kRing) slot -= kRing;
            add_norms(r1[j], rm[j], rs[j], raw[slot * TW], m[0][j], m[1][j],
                      m[2][j], c2, v);
          }
        }
      });
  const double sum = block_sums(v, red);
  if (tid < kSums)
    partial[(static_cast<long long>(plane) * gridDim.x * gridDim.y +
             static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) *
                kSums +
            tid] = sum;
}

// blur_sums_kernel's second pass: norms_fold_kernel under a name of its
// own, so that a trace tells the two paths apart.
__global__ void __launch_bounds__(kNormThreads)
blur_sums_fold_kernel(const double* __restrict__ partial, int nblk,
                      double* __restrict__ out) {
  fold_partials(partial, nblk, out);
}

template <int R>
cudaError_t launch_blur_sums(const float* img1, const float* mu1,
                             const float* s11, long long ref_stride,
                             const float* img2, int n, int h, int w,
                             const float* taps, int vec, float c2,
                             double* partial, int nblk, double* out,
                             cudaStream_t stream) {
  auto kernel = blur_sums_kernel<R>;
  // the blur's strip and a fourth ring map: 52 KB at radius 8
  constexpr size_t smem = BlurStrip<R>::bytes(2, 4);
  static_assert(smem * kSumBlocks <= 220 * 1024, "kSumBlocks to an SM");
  if constexpr (smem > 48 * 1024) {
    // once per device, not at every launch: set at every launch, calls
    // at 512x512x4 took 0.109 ms back to back on an H100 against 0.042
    // on the card, as if the host waited for the launches before
    static std::atomic<unsigned long long> raised{0};  // bit d: device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
    if (!bit || !(raised.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      raised.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const dim3 grid((w + kStripW - 1) / kStripW, (h + kSegRows - 1) / kSegRows,
                  3 * n);
  kernel<<<grid, kBlurThreads, smem, stream>>>(img1, mu1, s11, ref_stride,
                                               img2, h, w, taps, vec, c2,
                                               partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blur_sums_fold_kernel<<<3 * n, kNormThreads, 0, stream>>>(partial, nblk,
                                                            out);
  return cudaGetLastError();
}

template <int R = kMaxRadius>
cudaError_t dispatch_blur_sums(int radius, const float* img1,
                               const float* mu1, const float* s11,
                               long long ref_stride, const float* img2,
                               int n, int h, int w, const float* taps,
                               int vec, float c2, double* partial, int nblk,
                               double* out, cudaStream_t stream) {
  if (radius == R)
    return launch_blur_sums<R>(img1, mu1, s11, ref_stride, img2, n, h, w,
                               taps, vec, c2, partial, nblk, out, stream);
  if constexpr (R > 0)
    return dispatch_blur_sums<R - 1>(radius, img1, mu1, s11, ref_stride,
                                     img2, n, h, w, taps, vec, c2, partial,
                                     nblk, out, stream);
  return cudaErrorInvalidValue;
}

constexpr int kIirThreads = 128;
constexpr int kIirWarps = kIirThreads / 32;
constexpr int kIirTile = 32;  // rows and columns of a tile
constexpr int kIirTileSize = kIirTile * kIirTile;
constexpr int kIirAhead = 8;  // rows whose loads the H pass issues at once
constexpr int kIirRowBlocks = 5;  // W-pass blocks to an SM (caps registers)

// One step of the recursion, in the reference's operation order
// ((B*x + a1*y1) + a2*y2) + a3*y3, every product and sum rounded (no FMA).
__device__ __forceinline__ float yvv_step(const float* c, float x, float y1,
                                          float y2, float y3) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c[0], x), __fmul_rn(c[1], y1)),
                             __fmul_rn(c[2], y2)),
                   __fmul_rn(c[3], y3));
}

// The two intermediates of the recursive blur (scratch: a forward pass's
// results; tmp: the W pass's) are private to it, so they are laid out for
// it: per (output, plane) as 32x32 tiles, tile (ty, tx) at
// (ty * wt + tx) * 1024 floats, row-major inside. The W pass writes and
// reads whole tiles (4 KB contiguous) and the H pass walks down a column
// of tiles reading 128 contiguous bytes per warp and row, consecutive rows
// back to back. Rows and columns beyond the plane are padding: written
// (zeros), never used.
__device__ __forceinline__ long long iir_tile_off(int y, int x, int wt) {
  return (static_cast<long long>(y >> 5) * wt + (x >> 5)) * kIirTileSize +
         ((y & 31) << 5) + (x & 31);
}

// One direction of the W pass for a warp's 32 rows (one row of tiles),
// through the warp's [32][33] tile in shared memory: the warp loads a
// chunk of 32 columns row by row (load(r, x): row r of the warp, column
// x), lane i then steps along row i of the tile with y1..y3 in registers
// and writes its results back in place (the pad of one float keeps both
// walks free of bank conflicts), and the warp stores the tile to dst's
// tile of that chunk. The next chunk's loads are issued before the chain
// runs. Forward walks the chunks and columns upwards from a zero state,
// backward downwards from the row's end.
template <bool kForward, class Load>
__device__ __forceinline__ void iir_walk_rows(Load load, float* dst, int nr,
                                              int w, const float* c,
                                              float (*tile)[kIirTile + 1],
                                              int lane) {
  const int chunks = (w + kIirTile - 1) / kIirTile;
  float next[kIirTile];
  auto fetch = [&](int chunk) {
    const int x = chunk * kIirTile + lane;
#pragma unroll
    for (int r = 0; r < kIirTile; ++r)
      next[r] = (r < nr && x < w) ? load(r, x) : 0.0f;
  };
  fetch(kForward ? 0 : chunks - 1);
  float y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
  for (int i = 0; i < chunks; ++i) {
    const int chunk = kForward ? i : chunks - 1 - i;
    const int cw = min(kIirTile, w - chunk * kIirTile);
#pragma unroll
    for (int r = 0; r < kIirTile; ++r) tile[r][lane] = next[r];
    __syncwarp();
    if (i + 1 < chunks) fetch(kForward ? chunk + 1 : chunk - 1);
    // 8 columns a round: their tile reads do not depend on the chain and
    // go ahead of it
#pragma unroll 8
    for (int j = 0; j < kIirTile; ++j) {
      const int col = kForward ? j : kIirTile - 1 - j;
      if (col < cw) {
        const float y = yvv_step(c, tile[lane][col], y1, y2, y3);
        y3 = y2;
        y2 = y1;
        y1 = y;
        tile[lane][col] = y;
      }
    }
    __syncwarp();
    float* out = dst + static_cast<long long>(chunk) * kIirTileSize + lane;
#pragma unroll
    for (int r = 0; r < kIirTile; ++r) out[r * kIirTile] = tile[r][lane];
    __syncwarp();
  }
}

// W pass: a warp per row of tiles (32 rows of one plane) of one output o
// (blockIdx.y). The input of output o is formed at the load: reference
// side a, a*a; distorted side b, b*b, a*b. Forward along the rows into
// scratch, backward from the rows' ends into tmp; both tiled, per (output,
// plane). planes = 3n; ref_planes: those of img1 (3 when one reference
// serves every candidate).
template <bool kDist>
__global__ void __launch_bounds__(kIirThreads, kIirRowBlocks)
iir_rows_kernel(const float* __restrict__ img1, int ref_planes,
                const float* __restrict__ img2, int planes, int h, int w,
                const float* __restrict__ coef, float* __restrict__ scratch,
                float* __restrict__ tmp) {
  __shared__ float tiles[kIirWarps][kIirTile][kIirTile + 1];
  const int o = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ht = (h + kIirTile - 1) / kIirTile;
  const int wt = (w + kIirTile - 1) / kIirTile;
  const long long group =
      static_cast<long long>(blockIdx.x) * kIirWarps + warp;
  if (group >= static_cast<long long>(planes) * ht)
    return;  // the warp's own exit: no block barrier follows
  const int plane = static_cast<int>(group / ht);
  const int ty = static_cast<int>(group - static_cast<long long>(plane) * ht);
  const int y0 = ty * kIirTile;
  const int nr = min(kIirTile, h - y0);
  const float c[4] = {coef[0], coef[1], coef[2], coef[3]};
  float (*tile)[kIirTile + 1] = tiles[warp];
  const float* a =
      img1 + (static_cast<long long>(plane % ref_planes) * h + y0) * w;
  const float* b =
      kDist ? img2 + (static_cast<long long>(plane) * h + y0) * w : nullptr;
  const long long base =
      ((static_cast<long long>(o) * planes + plane) * ht + ty) * wt *
      kIirTileSize;
  float* s = scratch + base;
  float* t = tmp + base;
  if constexpr (kDist) {
    if (o == 0) {
      iir_walk_rows<true>(
          [&](int r, int x) { return b[static_cast<long long>(r) * w + x]; },
          s, nr, w, c, tile, lane);
    } else if (o == 1) {
      iir_walk_rows<true>(
          [&](int r, int x) {
            const float vb = b[static_cast<long long>(r) * w + x];
            return __fmul_rn(vb, vb);
          },
          s, nr, w, c, tile, lane);
    } else {
      iir_walk_rows<true>(
          [&](int r, int x) {
            return __fmul_rn(a[static_cast<long long>(r) * w + x],
                             b[static_cast<long long>(r) * w + x]);
          },
          s, nr, w, c, tile, lane);
    }
  } else {
    if (o == 0) {
      iir_walk_rows<true>(
          [&](int r, int x) { return a[static_cast<long long>(r) * w + x]; },
          s, nr, w, c, tile, lane);
    } else {
      iir_walk_rows<true>(
          [&](int r, int x) {
            const float va = a[static_cast<long long>(r) * w + x];
            return __fmul_rn(va, va);
          },
          s, nr, w, c, tile, lane);
    }
  }
  // the lane reads back what it wrote itself
  iir_walk_rows<false>(
      [&](int r, int x) {
        return s[static_cast<long long>(x >> 5) * kIirTileSize +
                 r * kIirTile + (x & 31)];
      },
      t, nr, w, c, tile, lane);
}

// H pass: one thread per (output o, candidate, channel, column), walking
// down then up the column of tmp (tiled: neighbouring threads read
// neighbouring columns, consecutive rows follow each other in memory), the
// forward pass into scratch (tiled alike), the backward pass into output
// o (row-major). The loads do not depend on the chain, so those of
// kIirAhead rows are issued together ahead of their steps.
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
  const int ht = (h + kIirTile - 1) / kIirTile;
  const int wt = (w + kIirTile - 1) / kIirTile;
  const long long hw = static_cast<long long>(h) * w;
  const long long base = (static_cast<long long>(o) * 3 * n + plane) * ht *
                         wt * kIirTileSize;
  const float* src = tmp + base;
  float* s = scratch + base;
  float* dst = (o == 0 ? out0 : (o == 1 ? out1 : out2)) + plane * hw + col;
  const float c[4] = {coef[0], coef[1], coef[2], coef[3]};
  float v[kIirAhead];
  float y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
  for (int y0 = 0; y0 < h; y0 += kIirAhead) {
#pragma unroll
    for (int u = 0; u < kIirAhead; ++u)
      if (y0 + u < h) v[u] = src[iir_tile_off(y0 + u, col, wt)];
#pragma unroll
    for (int u = 0; u < kIirAhead; ++u) {
      if (y0 + u < h) {
        const float y = yvv_step(c, v[u], y1, y2, y3);
        y3 = y2;
        y2 = y1;
        y1 = y;
        s[iir_tile_off(y0 + u, col, wt)] = y;
      }
    }
  }
  y1 = y2 = y3 = 0.0f;
  for (int y0 = h - 1; y0 >= 0; y0 -= kIirAhead) {
#pragma unroll
    for (int u = 0; u < kIirAhead; ++u)
      if (y0 - u >= 0) v[u] = s[iir_tile_off(y0 - u, col, wt)];
#pragma unroll
    for (int u = 0; u < kIirAhead; ++u) {
      if (y0 - u >= 0) {
        const float y = yvv_step(c, v[u], y1, y2, y3);
        y3 = y2;
        y2 = y1;
        y1 = y;
        dst[static_cast<long long>(y0 - u) * w] = y;
      }
    }
  }
}

int pyr_blocks(long long total) {
  const long long b = (total + kPyrThreads - 1) / kPyrThreads;
  return static_cast<int>(b < kPyrMaxBlocks ? b : kPyrMaxBlocks);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool blur_args_ok(int n, int h, int w, int halo, int radius) {
  return n > 0 && h > 0 && w > 0 && 3LL * n <= 65535 && radius >= 0 &&
         radius <= kMaxRadius && halo >= 0 && halo <= kMaxRadius;
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
  if (!blur_args_ok(n, h, w, halo, radius)) return cudaErrorInvalidValue;
  const long long hw_in = static_cast<long long>(h) * (w + 2 * halo);
  // 16-byte staging loads: every row and the staged span start on 16 bytes
  const int vec = (w + 2 * halo) % 4 == 0 && halo % 4 == 0 &&
                  aligned16(img1) && aligned16(img2);
  if (img2 == nullptr)
    return static_cast<int>(dispatch_blur<false>(
        radius, img1, 3 * hw_in, nullptr, n, h, w, halo, taps, vec, out0,
        out1, nullptr, stream));
  return static_cast<int>(dispatch_blur<true>(
      radius, img1, ref_batched ? 3 * hw_in : 0, img2, n, h, w, halo, taps,
      vec, out0, out1, out2, stream));
}

// ssim2_blur through blur_simple_kernel: the same arguments, the same
// bits.
extern "C" int ssim2_blur_simple(const float* img1, int ref_batched,
                                 const float* img2, int n, int h, int w,
                                 int halo, const float* taps, int radius,
                                 float* out0, float* out1, float* out2,
                                 cudaStream_t stream) {
  if (!blur_args_ok(n, h, w, halo, radius)) return cudaErrorInvalidValue;
  const long long hw_in = static_cast<long long>(h) * (w + 2 * halo);
  const dim3 grid((w + kSimpleTile - 1) / kSimpleTile,
                  (h + kSimpleTile - 1) / kSimpleTile, 3 * n);
  if (img2 == nullptr) {
    blur_simple_kernel<false><<<grid, kBlurThreads, 0, stream>>>(
        img1, 3 * hw_in, nullptr, h, w, halo, taps, radius, out0, out1,
        nullptr);
  } else {
    blur_simple_kernel<true><<<grid, kBlurThreads, 0, stream>>>(
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
// tmp: k * n * 3 * ceil(h/32) * ceil(w/32) * 1024 floats each (k = 2 or 3
// outputs; 32x32 tiles). coef: B, a1, a2, a3.
extern "C" int ssim2_blur_iir(const float* img1, int ref_batched,
                              const float* img2, int n, int h, int w,
                              const float* coef, float* scratch, float* tmp,
                              float* out0, float* out1, float* out2,
                              cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const int k = img2 == nullptr ? 2 : 3;
  const long long planes = 3LL * n;
  const long long groups = planes * ((h + kIirTile - 1) / kIirTile);
  const long long cols = k * planes * w;
  const long long rb = (groups + kIirWarps - 1) / kIirWarps;
  if (planes > (1LL << 31) - 1 || rb > (1LL << 31) - 1 ||
      cols > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  const int cb = static_cast<int>((cols + kIirThreads - 1) / kIirThreads);
  const dim3 rgrid(static_cast<unsigned>(rb), k);
  if (img2 == nullptr) {
    iir_rows_kernel<false><<<rgrid, kIirThreads, 0, stream>>>(
        img1, 3 * n, nullptr, 3 * n, h, w, coef, scratch, tmp);
  } else {
    iir_rows_kernel<true><<<rgrid, kIirThreads, 0, stream>>>(
        img1, ref_batched ? 3 * n : 3, img2, 3 * n, h, w, coef, scratch, tmp);
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

// ssim2_norms of the distorted side's blur, in one pass that keeps mu2,
// s22 and s12 out of device memory: the (n, 3, 6) float64 sums that
// ssim2_norms(img1, mu1, s11, img2, ssim2_blur(img1, img2)) gives, from
// the same float32 maps (the blur's bits), summed in another order.
// img1, mu1, s11 (n or 1, 3, h, w; ref_batched says which); img2 (n, 3, h,
// w); taps: 2*radius+1 floats, radius 0..8; partial: scratch of n * 3 *
// nblk * 6 doubles, nblk = ceil(w/64) * ceil(h/128) (the blur's strips
// and segments).
extern "C" int ssim2_blur_norms(const float* img1, const float* mu1,
                                const float* s11, int ref_batched,
                                const float* img2, int n, int h, int w,
                                const float* taps, int radius, float c2,
                                double* partial, int nblk, double* out,
                                cudaStream_t stream) {
  if (!blur_args_ok(n, h, w, 0, radius) ||
      static_cast<long long>(nblk) !=
          static_cast<long long>((w + kStripW - 1) / kStripW) *
              ((h + kSegRows - 1) / kSegRows))
    return cudaErrorInvalidValue;
  const long long hw = static_cast<long long>(h) * w;
  // 16-byte staging loads: every row and the staged span start on 16 bytes
  const int vec = w % 4 == 0 && aligned16(img1) && aligned16(img2);
  return static_cast<int>(dispatch_blur_sums(
      radius, img1, mu1, s11, ref_batched ? 3 * hw : 0, img2, n, h, w, taps,
      vec, c2, partial, nblk, out, stream));
}
