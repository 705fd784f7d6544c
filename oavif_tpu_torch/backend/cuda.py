"""GPU encoder backend: the port's product encode path.

Division of labour: the frame's partition and intra-mode search runs on
the device, one planning step per probe over device-resident planes
(``oavif_tpu_torch.av1.encode_tpu``); the entropy-serial work (exact
prediction, transform and RDOQ under the plan, symbol coding,
reconstruction, deblocking, CDEF, muxing) runs in the port's copy of the
reference's C runtime on the host.
"""

from __future__ import annotations

from . import EncCtx


class CudaBackend:
    name = "cuda"

    def encode(self, ctx: EncCtx) -> bytes:
        from ..av1.encode import encode_avif

        return encode_avif(ctx)

    def encode_with_recon(self, ctx: EncCtx):
        """Encode and return (bytes, recon RGB8). The recon equals the
        decoder's output, so the TQ loop scores it directly without a
        decode round-trip."""
        from ..av1.encode import encode_avif_with_recon

        return encode_avif_with_recon(ctx)
