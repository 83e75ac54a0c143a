"""Czochralski COMSOL data ingestion and nondimensionalization (port of
qcpinn_tpu/data/cz_loader.py; CG_HQPINN_IBMtest_16qubits.py:260-305).

Parses the COMSOL 6.2 text export (data/cz_melt_raw.txt: '%' comment
header, whitespace-separated columns; >= 9 columns -> take [0,1,4,5,6,7,8]
as r, z, u, w, vtheta, p, T; exactly 7 columns -> as is), scales lengths by
the max |r|,|z|, velocities by the max |u|,|w|,|vtheta|, pressure by max
|p|, temperature min-max, and computes pressure_coeff = p_scale / V^2 (the
factor mapping the dataset pressure to the V^2-scaled nondimensional NS
convention).

Host-side numpy, as in the JAX package. ``read_table`` is the JAX loader's
pure-Python parser (its mmap parser, ``native/loader.cc``, lies outside the
package and gives the same array); the arrays reach the card in the
pipeline.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class DataStats:
    length_scale: float
    velocity_scale: float
    pressure_scale: float
    temp_min: float
    temp_max: float
    pressure_coeff: float

    @property
    def temp_scale(self) -> float:
        return max(self.temp_max - self.temp_min, 1e-12)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DataStats":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in d.items() if k in fields})


def read_table(file_path: str) -> np.ndarray:
    """Parse a whitespace/comma numeric table with '%'/'#' comment lines
    into float64 ``[rows, cols]``. Rows with a deviating column count are
    skipped; a non-numeric row (a CSV header) is skipped."""
    rows = []
    with open(file_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("%") or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                continue
    if not rows:
        raise ValueError(f"no numeric rows parsed from {file_path}")
    width = max(len(r) for r in rows)
    return np.asarray([r for r in rows if len(r) == width], dtype=np.float64)


def load_cz_data(
    file_path: str, stats: "DataStats | None" = None
) -> Tuple[np.ndarray, np.ndarray, DataStats]:
    """(X [N, 2] = (r, z), Y [N, 5] = (u_r, u_z, u_theta, p, T), stats), all
    nondimensionalized, float32 numpy.

    With ``stats`` (a checkpoint's saved DataStats) the data is normalized
    with those scales instead of the file's own, so a model trained on one
    export evaluates and finetunes in its own normalized space
    (CG_HQPINN_IBMtest_16qubits.py:560-562)."""
    data = read_table(file_path)
    if data.shape[1] >= 9:
        frame = data[:, [0, 1, 4, 5, 6, 7, 8]]
    elif data.shape[1] == 7:
        frame = data
    else:
        raise ValueError(
            f"Unsupported data shape {data.shape}. Expected 7 or >= 9 columns.")

    r, z = frame[:, 0], frame[:, 1]
    u, w, vtheta = frame[:, 2], frame[:, 3], frame[:, 4]
    p, T = frame[:, 5], frame[:, 6]

    if stats is not None:
        length_scale = stats.length_scale
        velocity_scale = stats.velocity_scale
        pressure_scale = stats.pressure_scale
        temp_min = stats.temp_min
        temp_max = stats.temp_max
        temp_scale = stats.temp_scale
        pressure_coeff = stats.pressure_coeff
    else:
        length_scale = float(max(np.abs(r).max(), np.abs(z).max(), 1e-12))
        velocity_scale = float(
            max(np.abs(u).max(), np.abs(w).max(), np.abs(vtheta).max(), 1e-12))
        pressure_scale = float(max(np.abs(p).max(), 1e-12))
        temp_min = float(T.min())
        temp_max = float(T.max())
        temp_scale = max(temp_max - temp_min, 1e-12)
        pressure_coeff = pressure_scale / max(velocity_scale**2, 1e-12)

    X = np.stack([r / length_scale, z / length_scale], axis=1).astype(np.float32)
    Y = np.stack(
        [u / velocity_scale, w / velocity_scale, vtheta / velocity_scale,
         p / pressure_scale, (T - temp_min) / temp_scale],
        axis=1,
    ).astype(np.float32)
    stats = DataStats(
        length_scale=length_scale,
        velocity_scale=velocity_scale,
        pressure_scale=pressure_scale,
        temp_min=temp_min,
        temp_max=temp_max,
        pressure_coeff=pressure_coeff,
    )
    return X, Y, stats


def choose_calibration_subset(
    X: np.ndarray, Y: np.ndarray, subset_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Coverage heuristic (CG_HQPINN_IBMtest_16qubits.py:430-440): sort by
    r + 0.25 z, take evenly spaced picks."""
    subset_size = min(subset_size, X.shape[0])
    if subset_size >= X.shape[0]:
        return X, Y
    order = np.argsort(X[:, 0] + 0.25 * X[:, 1])
    picks = np.round(np.linspace(0, len(order) - 1, subset_size)).astype(np.int64)
    idx = order[picks]
    return X[idx], Y[idx]


def infer_boundary_masks(x_phys: np.ndarray, tol: float = 1e-3) -> dict:
    """Boundary masks of the axisymmetric (r, z) domain
    (si_q_pinn_improved.py:219-231): the points within ``tol`` of the
    domain's extent on each side, boolean over the node axis: ``axis`` (r =
    r_min), ``outer_wall`` (r = r_max), ``inlet`` (z = z_min), ``outlet`` (z
    = z_max). ``x_phys`` is ``[N, >= 2]`` with columns (r, z, ...); each
    tolerance is relative to its coordinate's span (floored)."""
    x_phys = np.asarray(x_phys)
    r, z = x_phys[:, 0], x_phys[:, 1]
    r_min, r_max = r.min(), r.max()
    z_min, z_max = z.min(), z.max()
    rt = tol * max(r_max - r_min, 1e-12)
    zt = tol * max(z_max - z_min, 1e-12)
    return {
        "axis": np.abs(r - r_min) <= rt,
        "outer_wall": np.abs(r - r_max) <= rt,
        "inlet": np.abs(z - z_min) <= zt,
        "outlet": np.abs(z - z_max) <= zt,
    }
