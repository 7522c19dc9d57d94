"""Oracles for the GEMM kernels (port of ``repro.kernels.ref``)."""
from __future__ import annotations

import numpy as np


def ref_int_gemm_i64(a, b) -> np.ndarray:
    """numpy int64 oracle — exact for all w <= 16 and any practical K.
    Accepts numpy arrays or CPU tensors."""
    return np.asarray(a, dtype=np.int64) @ np.asarray(b, dtype=np.int64)
