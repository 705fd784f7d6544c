// Source edges of one intra block, shared by the planner
// (planner.cu) and the device encode stage (device_stage.cu).
//
// The counterpart of _grid_edges in oavif_tpu/av1/encode_tpu.py (and
// oavif_tpu_torch/av1/encode_tpu.py): the above row, left column and
// corner of block (bi, bj) at a P grid, read from the (+1,+1)-padded int16
// plane, with the decoder's unavailability fills (spec 7.11.2) applied in
// the reference's order: above from the unfilled left, left from the
// filled above, then the corner. The fills go by the block's grid index in
// the frame, never by what the padding holds: pad_plane's border row and
// column (base-1, base+1) are not the fills.

#pragma once

#include <cstdint>

namespace oavif {

template <int P>
struct Log2 {
  static constexpr int value = P == 16 ? 4 : (P == 32 ? 5 : 6);
};

// pix(i, j): the padded plane at row i, column j from a block's row above
// and column left (so pix(1 + r, 1 + c) is the block's pixel (r, c)), in
// device memory or in a CTA's shared-memory copy.
struct Pix {
  const int16_t* p;
  int ld;
  __device__ __forceinline__ int operator()(int i, int j) const {
    return p[i * ld + j];
  }
};

// above[k], left[k] and the corner of a block, filled; row0 / col0: the
// block lies in the frame's first block row / column.
__device__ __forceinline__ int fill_above(const Pix& pix, bool row0,
                                          bool col0, int base, int k) {
  if (row0) return col0 ? base - 1 : pix(1, 0);  // left[0], or base-1
  return pix(0, 1 + k);
}

__device__ __forceinline__ int fill_left(const Pix& pix, bool row0,
                                         bool col0, int base, int k) {
  if (col0) return row0 ? base + 1 : pix(0, 1);  // above[0], or base+1
  return pix(1 + k, 0);
}

__device__ __forceinline__ int fill_corner(const Pix& pix, bool row0,
                                           bool col0, int base) {
  if (row0 && col0) return base;
  if (row0) return pix(1, 0);
  if (col0) return pix(0, 1);
  return pix(0, 0);
}

// Element i of the edge vector [corner, above[0..P), above[P-1] x P,
// corner, left[0..P), left[P-1] x P] (the vector the planner's
// directional taps index), 0 <= i < 2 * (2P + 1).
template <int P>
__device__ __forceinline__ int edge_at(const Pix& pix, bool row0, bool col0,
                                       int base, int i) {
  constexpr int L = 2 * P + 1;
  if (i == 0 || i == L) return fill_corner(pix, row0, col0, base);
  if (i < L) return fill_above(pix, row0, col0, base, min(i - 1, P - 1));
  return fill_left(pix, row0, col0, base, min(i - L - 1, P - 1));
}

// Fills edge[0, 2*(2P+1)) of block (bi, bj) from the padded plane in
// device memory. Every thread of the block calls it; it ends with
// __syncthreads().
template <int P, int kThreads>
__device__ __forceinline__ void load_edges(const int16_t* __restrict__ plane,
                                           int ld, int bi, int bj, int base,
                                           int* edge) {
  const Pix pix{plane + (bi * P) * ld + bj * P, ld};
  for (int i = threadIdx.x; i < 2 * (2 * P + 1); i += kThreads)
    edge[i] = edge_at<P>(pix, bi == 0, bj == 0, base, i);
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
