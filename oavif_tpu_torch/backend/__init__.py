"""Encoder backend of the port: ``cuda.CudaBackend``, the counterpart of
``oavif_tpu.backend.tpu.TpuBackend``. The encoder context and bitstream
cache types are the reference's."""

from oavif_tpu.backend import EncBuffer, EncCtx  # noqa: F401
