// Device encode stage: open-loop 16x16 forward coefficients (K3a) and
// their round-half quantization at a batch of quantizers (K3b).
//
// K3a, dstage_coeffs16, replaces oavif_tpu/av1/device_stage.py
// _coeffs_body (jit :101): for every 16x16 luma block, the prediction of
// its PLANNED mode (one of DC, V, H, SMOOTH, PAETH, SMOOTH_V, SMOOTH_H)
// from source edges, the residual block - prediction, and the forward
// DCT16 fh @ R @ fw^T. The reference predicts all 7 modes into an
// (n, 7, 16, 16) stack and selects with a one-hot einsum; here one thread
// block per 16x16 block builds its edges in shared memory
// (intra_edges.cuh, the planner's code), each of its 256 threads predicts
// its pixel under the one planned mode in exact integers, and the two
// 16x16 products run out of shared memory, each output summed in a fixed
// k order with __fmaf_rn. Nothing but the coefficients reaches global
// memory.
//
// K3b, dstage_quant16, replaces device_stage.py _quant_body (vmapped over
// the quantizers, jit :102): grid (blocks, quantizers), one thread per
// coefficient. The level is floor(|c| * up / dq + 0.5) with every
// operation rounded as in the plain version (__fmul_rn, __fdiv_rn,
// __fadd_rn: no contraction, IEEE division), then the sign and the clip
// to +-16383. eob is the largest scan position + 1 over the nonzero
// levels: a warp-shuffle max and one shared-memory step, no atomics. The
// reference's 256x256 permutation matmul (a TPU workaround for gathers)
// becomes a read of the inverse scan table.
//
// What bounds them on the H100: at 3840x2160 (31,680 blocks) K3a reads
// 16.2 MB of int16 plane and writes 32.4 MB of float32 coefficients
// against ~0.5 GFLOP, and K3b reads 32.4 MB and writes 16.2 MB of levels
// per quantizer: both are bound by HBM bytes (~15 us each at 3.35 TB/s),
// with one block per 16x16 tile and coalesced row reads and writes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC (oavif_tpu_torch/kernels/build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "intra_edges.cuh"

namespace {

constexpr int kThreads = 256;  // one per pixel or coefficient of a block
constexpr int kWarps = kThreads / 32;
constexpr int kLevelMax = 16383;

__global__ void __launch_bounds__(kThreads)
coeffs16_kernel(const int16_t* __restrict__ plane, int ld, int nbx,
                int base, const int32_t* __restrict__ modes,
                const int32_t* __restrict__ smw,
                const float* __restrict__ fh, const float* __restrict__ fw,
                float* __restrict__ out) {
  constexpr int P = 16;
  constexpr int L = 2 * P + 1;
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

  // the planned mode's prediction, as the reference's integer-valued
  // formulas (oavif_tpu_torch/av1/encode_tpu.py _predictions)
  const int a = edge[1 + c], l = edge[L + 1 + r], cr = edge[0];
  const int below = edge[L + P], right = edge[P];  // left[P-1], above[P-1]
  const int wr = smw[r], wc = smw[c];
  int pred;
  switch (modes[blk]) {
    case 1:  // V
      pred = a;
      break;
    case 2:  // H
      pred = l;
      break;
    case 3:  // SMOOTH
      pred = (wr * a + (256 - wr) * below + wc * l + (256 - wc) * right +
              256) >> 9;
      break;
    case 4: {  // PAETH
      const int pa = abs(l - cr), pl = abs(a - cr), pc = abs(a + l - 2 * cr);
      pred = (pa <= pl && pa <= pc) ? a : (pl <= pc ? l : cr);
      break;
    }
    case 5:  // SMOOTH_V
      pred = (wr * a + (256 - wr) * below + 128) >> 8;
      break;
    case 6:  // SMOOTH_H
      pred = (wc * l + (256 - wc) * right + 128) >> 8;
      break;
    default:  // 0, DC (the host checks the range)
      pred = dc_s;
  }
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

__global__ void __launch_bounds__(kThreads)
quant16_kernel(const float* __restrict__ coeffs, int n,
               const float* __restrict__ dq_dc,
               const float* __restrict__ dq_ac, float up,
               const int32_t* __restrict__ iscan,
               int16_t* __restrict__ levels, int32_t* __restrict__ eob) {
  __shared__ int red[kWarps];
  const int blk = blockIdx.x, q = blockIdx.y, tid = threadIdx.x;
  const long long row = static_cast<long long>(q) * n + blk;

  const float cf = coeffs[static_cast<long long>(blk) * kThreads + tid];
  const float dq = tid == 0 ? dq_dc[q] : dq_ac[q];
  const float mag =
      floorf(__fadd_rn(__fdiv_rn(__fmul_rn(fabsf(cf), up), dq), 0.5f));
  const float v = fminf(fmaxf(cf < 0.0f ? -mag : mag,
                              static_cast<float>(-kLevelMax)),
                        static_cast<float>(kLevelMax));
  const int lv = static_cast<int>(v);
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

}  // namespace

// plane: (>= 16*nby+1, ld) int16, the (+1,+1)-padded plane, row stride ld.
// modes: (nby*nbx,) int32 mode indices 0..6. smw: (16,) int32 smooth
// weights. fh, fw: (16, 16) float32 forward matrices. out: (nby*nbx, 16,
// 16) float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int dstage_coeffs16(const int16_t* plane, int ld, int nby,
                               int nbx, int base, const int32_t* modes,
                               const int32_t* smw, const float* fh,
                               const float* fw, float* out,
                               cudaStream_t stream) {
  if (nby <= 0 || nbx <= 0) return cudaErrorInvalidValue;
  coeffs16_kernel<<<dim3(nby * nbx), kThreads, 0, stream>>>(
      plane, ld, nbx, base, modes, smw, fh, fw, out);
  return static_cast<int>(cudaGetLastError());
}

// coeffs: (n, 16, 16) float32. dq_dc, dq_ac: (k,) float32. up: 2^shift.
// iscan: (256,) int32 scan position of each natural index. levels:
// (k, n, 256) int16, natural order. eob: (k, n) int32. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dstage_quant16(const float* coeffs, int n, int k,
                              const float* dq_dc, const float* dq_ac,
                              float up, const int32_t* iscan,
                              int16_t* levels, int32_t* eob,
                              cudaStream_t stream) {
  if (n <= 0 || k <= 0 || k > 65535) return cudaErrorInvalidValue;
  quant16_kernel<<<dim3(n, k), kThreads, 0, stream>>>(
      coeffs, n, dq_dc, dq_ac, up, iscan, levels, eob);
  return static_cast<int>(cudaGetLastError());
}
