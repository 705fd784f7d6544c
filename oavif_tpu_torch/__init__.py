"""oavif-tpu-torch: the PyTorch/CUDA port of oavif-tpu for one NVIDIA H100.

The JAX package ``oavif_tpu`` stays the reference; this package imports
nothing of it. It owns the modules whose reference counterparts import JAX
(the frame planner, the device encode stage, the frame and AVIF encode
entry points, the device metric and the scorer selection, the backend, the
search driver and pipeline, the CLI), and keeps its own copies of the
reference's JAX-free host runtime: options, image I/O, the TQ search
algorithms, the AV1 bitstream writers and filters, the Python tile coder
and the native C runtime (tile coder, deblocking, CDEF, SSIMULACRA2),
which builds into ``build/oavif_tpu_torch/``.

Device work runs in hand-written CUDA kernels (``csrc/``): the frame
planner's per-block intra-mode SSD (``planner.cu``), the SSIMULACRA2
pyramid, blurs (FIR, with a halo for a width shard, and recursive) and
norms (``ssimulacra2.cu``), the encode stage's 16x16 coefficients and
quantization (``device_stage.cu``), and the Wiener loop-restoration
filter (``wiener.cu``). The multi-device leg runs on ``torch.distributed``
(``parallel.py``, ``metric/sharded.py``, ``av1/restoration_sharded.py``,
``graft_entry.py``).
"""

__version__ = "0.1.0"
