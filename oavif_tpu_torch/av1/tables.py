"""Loader for the extracted AV1 constant tables (see
tools/extract_av1_tables.py). Regenerate with:

    python tools/extract_av1_tables.py
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_NPZ = Path(__file__).parent / "av1_tables.npz"


class _Tables:
    def __init__(self) -> None:
        self._data = None

    def _load(self):
        if self._data is None:
            self._data = dict(np.load(_NPZ))
        return self._data

    def __getitem__(self, key: str) -> np.ndarray:
        return self._load()[key]

    def __contains__(self, key: str) -> bool:
        return key in self._load()


TABLES = _Tables()


def dc_q(qindex: int, bitdepth: int = 8) -> int:
    return int(TABLES[f"dc_q{bitdepth}"][np.clip(qindex, 0, 255)])


def ac_q(qindex: int, bitdepth: int = 8) -> int:
    return int(TABLES[f"ac_q{bitdepth}"][np.clip(qindex, 0, 255)])
