"""TUM trajectory format IO (`timestamp x y z qx qy qz qw`; copy of
``cvids_tpu/io/tum.py``).

The reference's ATE-evaluation output path (`server_plotter.h:158-273` dumps
pose1..4.txt in this format). Note the reference (and TUM tooling) order
quaternions (qx, qy, qz, qw); internally the packages use (w, x, y, z).
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_tum", "read_tum"]


def write_tum(path: str, rows: np.ndarray) -> None:
    """rows: (N, 8) [t, x, y, z, qw, qx, qy, qz] (internal order)."""
    out = np.asarray(rows, np.float64).copy()
    out[:, 4:] = np.concatenate([rows[:, 5:8], rows[:, 4:5]], axis=1)  # -> xyzw
    np.savetxt(path, out, fmt="%.9f")


def read_tum(path: str) -> np.ndarray:
    """Returns (N, 8) [t, x, y, z, qw, qx, qy, qz] (internal order)."""
    data = np.loadtxt(path).reshape(-1, 8)
    out = data.copy()
    out[:, 4] = data[:, 7]
    out[:, 5:8] = data[:, 4:7]
    return out
