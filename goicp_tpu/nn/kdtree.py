"""Host-side k-d tree — verification oracle only.

The reference builds nanoflann k-d trees (``src/kdTree.hpp:44-77``) and even
flattens one for in-kernel GPU traversal (``src/icp_kernel.cu:281-377``),
then concludes the tree LOSES to dense lookups on GPU (``README.md:103-106``).
Pointer-chasing is hostile to wide accelerators in general, so the compute
path uses dense fields / streamed brute force; this module
exists for host-side verification oracles and as the C9 component parity.

Uses scipy's cKDTree when available, else a small pure-numpy implementation.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.spatial import cKDTree as _SciKDTree
except Exception:  # pragma: no cover
    _SciKDTree = None


class KDTree:
    """NN queries over a fixed target cloud ``[Nt, 3]``."""

    def __init__(self, targets: np.ndarray, leaf_size: int = 10):
        self.targets = np.ascontiguousarray(targets, np.float32)
        if _SciKDTree is not None:
            self._tree = _SciKDTree(self.targets, leafsize=leaf_size)
        else:
            self._tree = None

    def query(self, points: np.ndarray):
        """Returns ``(dist [Q], index [Q])`` — exact nearest neighbors."""
        points = np.asarray(points, np.float32)
        if self._tree is not None:
            d, i = self._tree.query(points, k=1)
            return d.astype(np.float32), i.astype(np.int64)
        # numpy fallback: tiled brute force
        out_d = np.empty(points.shape[0], np.float32)
        out_i = np.empty(points.shape[0], np.int64)
        for s in range(0, points.shape[0], 1024):
            e = min(s + 1024, points.shape[0])
            diff = points[s:e, None, :] - self.targets[None, :, :]
            d2 = np.einsum("qnk,qnk->qn", diff, diff)
            out_i[s:e] = d2.argmin(1)
            out_d[s:e] = np.sqrt(d2[np.arange(e - s), out_i[s:e]])
        return out_d, out_i
