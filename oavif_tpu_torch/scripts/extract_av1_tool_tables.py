"""Extract the AV1 tables the AVIF reader needs beyond the encoder's
(``oavif_tpu_torch/av1/av1_tables.npz``) from a libaom binary's ``.rodata``
and write ``oavif_tpu_torch/io/av1_tool_tables.npz``:

- ``qm``: the inverse quantizer matrices (spec Quantizer_Matrix, libaom's
  ``iwt_matrix_ref``), 15 levels x 2 plane types (luma, chroma) x 3344
  weights, uint8; level 15 is flat and has no table;
- ``gaussian_sequence``: the film grain's 2048 Gaussian samples (spec
  Gaussian_Sequence), int16;
- ``delta_q`` and ``delta_lf``: the default CDFs of ``delta_q_abs`` and
  ``delta_lf_abs`` (spec Default_Delta_Q_Cdf, Default_Delta_Lf_Cdf; the
  multi-LF CDFs start as four copies of the latter), inverse-CDF uint16
  with the closing 0, as the other tables store them.

Each table is found by a structural signature and checked against anchor
values before anything is written: the matrices by their first 4x4 (the
spec's first row), the symmetry of every square matrix (and each w x h
the transpose of h x w), their range and their product with the forward
matrices that follow them in libaom's ``.rodata``; the Gaussian samples by their first eight values, their range
and their spacing of 4; the CDFs by the spec's values.

    python -m oavif_tpu_torch.scripts.extract_av1_tool_tables [LIBAOM]

LIBAOM defaults to the Debian runtime,
``/usr/lib/x86_64-linux-gnu/libaom.so.3.6.0``. ``objcopy`` must be on the
path.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

LIBAOM = "/usr/lib/x86_64-linux-gnu/libaom.so.3.6.0"
OUT = Path(__file__).resolve().parent.parent / "io" / "av1_tool_tables.npz"

QM_LEVELS = 15
QM_TOTAL = 3344
# (width, height) of each stored matrix in table order, as the spec's
# Qm_Offset walks them: the 64-point sizes reuse the 32-point ones
QM_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
            (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8))
QM_FIRST = (32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150,
            200)
GAUSS_FIRST = (56, 568, -180, 172, 124, -84, 172, -64)
DELTA_CDF = (28160, 32120, 32677)  # AOM_CDF4, both delta-q and delta-LF


def rodata(lib: str) -> bytes:
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        subprocess.run(["objcopy", "-O", "binary", "--only-section=.rodata",
                        lib, f.name], check=True)
        return Path(f.name).read_bytes()


def require(ok, what: str) -> None:
    """Refuse the binary where a table fails its check."""
    if not ok:
        raise ValueError(f"libaom's tables: {what}")


def find_once(data: bytes, pattern: bytes, what: str) -> int:
    at = data.find(pattern)
    require(at >= 0 and data.find(pattern, at + 1) < 0,
            f"{what}: not exactly one match")
    return at


def quantizer_matrices(data: bytes) -> np.ndarray:
    at = find_once(data, bytes(QM_FIRST), "inverse quantizer matrices")
    n = QM_LEVELS * 2 * QM_TOTAL
    iwt = np.frombuffer(data, np.uint8, n, at).reshape(QM_LEVELS, 2, QM_TOTAL)
    wt = np.frombuffer(data, np.uint8, n, at + n).reshape(iwt.shape)
    # weights of 2^5 scale: the flattest levels round to 31-34
    require(iwt.min() >= 30 and 0 < wt.min() and wt.max() <= 34,
            "quantizer matrix weights out of range")
    # forward and inverse weights multiply to 2^10 within the rounding of
    # the forward weight
    prod = wt.astype(np.int32) * iwt
    require(np.all(np.abs(prod - 1024) <= (iwt + 1) // 2),
            "forward and inverse weights do not multiply to 1024")
    mats, off = {}, 0
    for w, h in QM_SIZES:
        mats[w, h] = iwt[..., off:off + w * h].reshape(QM_LEVELS, 2, h, w)
        off += w * h
    # the square matrices are symmetric, each w x h the transpose of h x w
    for w, h in QM_SIZES:
        require(np.array_equal(mats[w, h], np.swapaxes(mats[h, w], 2, 3)),
                f"the {w}x{h} matrix is not the {h}x{w} one transposed")
    # the levels flatten towards 15
    require(iwt[QM_LEVELS - 1].max() <= iwt[0].max(), "level order")
    return iwt.copy()


def gaussian_sequence(data: bytes) -> np.ndarray:
    at = find_once(data, np.array(GAUSS_FIRST, "<i4").tobytes(),
                   "Gaussian sequence")
    g = np.frombuffer(data, "<i4", 2048, at)
    require(np.all(g % 4 == 0) and np.abs(g).max() < 2048,
            "Gaussian samples off their grid")
    require(abs(float(g.mean())) < 16 and 400 < float(g.std()) < 600,
            "Gaussian samples' mean or spread")
    return g.astype(np.int16)


def delta_cdf(data: bytes) -> np.ndarray:
    unit = np.array([32768 - p for p in DELTA_CDF] + [0, 0], "<u2")
    require(data.find(unit.tobytes()) >= 0, "delta q / delta LF CDF not found")
    return unit[:4].astype(np.uint16)


def main(argv: list) -> None:
    lib = argv[0] if argv else LIBAOM
    data = rodata(lib)
    cdf = delta_cdf(data)
    tables = {"qm": quantizer_matrices(data),
              "gaussian_sequence": gaussian_sequence(data),
              "delta_q": cdf, "delta_lf": cdf.copy()}
    np.savez_compressed(OUT, **tables)
    for k, v in tables.items():
        print(f"{k}: {v.shape} {v.dtype}")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main(sys.argv[1:])
