"""The in-repo registration fixtures under ``data_generated/``.

Each ``<name>.ply`` is a target cloud made by moving a source scan with the
rigid transform stored beside it in ``<name>_gt.toml``
(``target = R @ source + t``, ``noise_std`` Gaussian noise on top).  The
source scan itself is recovered by inverting that transform, so every
fixture is a registration pair with a known answer and no download.
"""

from __future__ import annotations

import os
import tomllib
from pathlib import Path

import numpy as np

from goicp_tpu.io.ply import read_ply

DATA_DIR = Path(__file__).resolve().parents[2] / "data_generated"


def load_gt(name: str) -> dict:
    """The ground-truth record of fixture ``name``: ``R [3,3]``, ``t [3]``,
    the original ``source`` file name, ``noise_std`` and ``seed``."""
    with open(DATA_DIR / f"{name}_gt.toml", "rb") as f:
        doc = tomllib.load(f)
    return {
        "R": np.asarray(doc["rotation"], np.float64),
        "t": np.asarray(doc["translation"], np.float64),
        "source": doc.get("source", ""),
        "noise_std": float(doc.get("noise_std", 0.0)),
        "seed": int(doc.get("seed", 0)),
    }


def load_pair(name: str = "rotated_bunny"):
    """``(source [N,3], target [N,3], R, t)`` for fixture ``name``: the
    target as stored and the source recovered as ``Rᵀ(target − t)``, row
    for row (exact correspondences when ``noise_std`` is 0)."""
    gt = load_gt(name)
    tgt = read_ply(os.fspath(DATA_DIR / f"{name}.ply")).astype(np.float64)
    src = (tgt - gt["t"]) @ gt["R"]
    return (src.astype(np.float32), tgt.astype(np.float32),
            gt["R"].astype(np.float32), gt["t"].astype(np.float32))
