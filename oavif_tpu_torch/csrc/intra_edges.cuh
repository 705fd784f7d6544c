// Source edges of one intra block, shared by the planner
// (planner.cu) and the device encode stage (device_stage.cu).
//
// The counterpart of _grid_edges in oavif_tpu/av1/encode_tpu.py (and
// oavif_tpu_torch/av1/encode_tpu.py): the above row, left column and
// corner of block (bi, bj) at a P grid, read from the (+1,+1)-padded int16
// plane, with the decoder's unavailability fills (spec 7.11.2) applied in
// the reference's order: above from the unfilled left, left from the
// filled above, then the corner.

#pragma once

#include <cstdint>

namespace oavif {

template <int P>
struct Log2 {
  static constexpr int value = P == 16 ? 4 : (P == 32 ? 5 : 6);
};

// Fills edge[0, 2*(2P+1)) = [corner, above[0..P), above[P-1] x P,
//                            corner, left[0..P),  left[P-1]  x P]
// (the vector the planner's directional taps index). Every thread of the
// block calls it; it ends with __syncthreads().
template <int P, int kThreads>
__device__ __forceinline__ void load_edges(const int16_t* __restrict__ plane,
                                           int ld, int bi, int bj, int base,
                                           int* edge) {
  constexpr int L = 2 * P + 1;
  const int y0 = bi * P, x0 = bj * P;  // padded row above / column left
  const int tid = threadIdx.x;
  for (int k = tid; k < P; k += kThreads) {
    int a, l;
    if (bi == 0)
      a = bj > 0 ? plane[(1 + y0) * ld + x0] : base - 1;
    else
      a = plane[y0 * ld + 1 + x0 + k];
    if (bj == 0)
      l = bi > 0 ? plane[y0 * ld + 1 + x0] : base + 1;
    else
      l = plane[(1 + y0 + k) * ld + x0];
    edge[1 + k] = a;
    edge[L + 1 + k] = l;
  }
  if (tid == 0) {
    int c;
    if (bi == 0 && bj == 0)
      c = base;
    else if (bi == 0)
      c = plane[(1 + y0) * ld + x0];
    else if (bj == 0)
      c = plane[y0 * ld + 1 + x0];
    else
      c = plane[y0 * ld + x0];
    edge[0] = c;
    edge[L] = c;
  }
  __syncthreads();
  for (int k = tid; k < P; k += kThreads) {
    edge[1 + P + k] = edge[P];
    edge[L + 1 + P + k] = edge[L + P];
  }
  __syncthreads();
}

// DC prediction from the filled edges: floor((sum above + sum left + P)
// / 2P), as the reference's floor division.
template <int P>
__device__ __forceinline__ int dc_pred(const int* edge) {
  constexpr int L = 2 * P + 1;
  int s = P;
  for (int k = 0; k < P; ++k) s += edge[1 + k] + edge[L + 1 + k];
  return s >> (Log2<P>::value + 1);
}

}  // namespace oavif
