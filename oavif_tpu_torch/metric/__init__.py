"""Image-quality metric for the search: the device SSIMULACRA2
(``ssimulacra2.py``, hand-written CUDA kernels) and the native C scorer
with the implementation selection (``native.py``)."""

from .ssimulacra2 import (  # noqa: F401
    compute_ssimulacra2,
    compute_ssimulacra2_batch,
    make_ref_scorer,
    ssimulacra2_precompute_ref,
)
