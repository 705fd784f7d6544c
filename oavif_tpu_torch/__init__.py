"""oavif-tpu-torch: the PyTorch/CUDA port of oavif-tpu for one NVIDIA H100.

The JAX package ``oavif_tpu`` stays the reference. This package owns the
modules whose reference counterparts import JAX (the frame planner, the
frame and AVIF encode entry points, the scorer selection, the backend, the
search driver and the CLI) and imports every JAX-free host module from
``oavif_tpu`` as it is: options, image I/O, the TQ search algorithms, the
AV1 bitstream writers and the native C runtime (tile coder, deblocking,
CDEF, SSIMULACRA2).

Device work: the frame planner's per-block intra-mode SSD runs as a
hand-written CUDA kernel (``csrc/planner.cu``); its epilogue (argmins and
partition gates) runs as small torch ops on the same device.
"""

__version__ = "0.1.0"
