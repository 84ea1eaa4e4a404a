"""Tiny pure-numpy Go-ICP oracle for optimality cross-checks.

A direct, unoptimized implementation of Yang et al.'s nested BnB with EXACT
nearest-neighbor distances (no DT/LUT approximation) — the semantics of
``src/goicp/jly_goicp.cpp`` reduced to its mathematical core.  Used only in
tests on very small clouds to validate that the device solver's results are
ε-optimal; deliberately independent of every goicp_tpu device code path.
"""

from __future__ import annotations

import heapq
import itertools
import math

import numpy as np

_SQRT3 = math.sqrt(3.0)
_OCT = np.array(
    [[(j >> a & 1) * 2 - 1 for a in range(3)] for j in range(8)], np.float64
)


def _rot(v):
    t = np.linalg.norm(v)
    if t < 1e-12:
        return np.eye(3)
    k = v / t
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(t) * K + (1 - math.cos(t)) * (K @ K)


def _nn_d(pts, tgt):
    d = pts[:, None, :] - tgt[None, :, :]
    return np.sqrt((d * d).sum(-1).min(1))


def _sse(src, tgt, R, t):
    return float((_nn_d(src @ R.T + t, tgt) ** 2).sum())


def oracle_min_sse(src, tgt, trans_span=0.5, mse_threshold=1e-5, max_nodes=200000,
                   trim_fraction=0.0):
    """ε-optimal min SSE over SO(3)×[-s,s]³ by exhaustive nested BnB.

    Returns ``(best_sse, best_R, best_t)`` with ``best_sse`` within
    ``mse_threshold·h`` of the global optimum (exact-NN bounds, no grid).
    ``trim_fraction > 0``: the objective is the trimmed SSE over the
    ``h = N·(1−trim)`` closest points (≙ jly trimming: ub = h smallest d²
    at the center; lb = h smallest per-point lower bounds — the optimum's
    inlier set dominates both)."""
    src = np.asarray(src, np.float64)
    tgt = np.asarray(tgt, np.float64)
    N = src.shape[0]
    h = max(1, int(round(N * (1.0 - trim_fraction))))
    norms = np.linalg.norm(src, axis=1)
    thresh = mse_threshold * h

    best = np.inf
    best_pose = (np.eye(3), np.zeros(3))

    # heap of (lb, counter, r_c, r_s, t_c, t_s)
    cnt = itertools.count()
    heap = [(0.0, next(cnt), np.zeros(3), math.pi, np.zeros(3), trans_span)]
    nodes = 0
    while heap and nodes < max_nodes:
        lb, _, r_c, r_s, t_c, t_s = heapq.heappop(heap)
        if lb >= best - thresh:
            break
        nodes += 1
        R = _rot(r_c)
        d = _nn_d(src @ R.T + t_c, tgt)
        ub = float(np.sort(d * d)[:h].sum())
        if ub < best:
            best = ub
            best_pose = (R, t_c.copy())
        g_r = 2.0 * np.sin(min(_SQRT3 * r_s, math.pi) / 2.0) * norms
        g_t = _SQRT3 * t_s
        node_lb = float(
            np.sort(np.maximum(d - g_r - g_t, 0.0) ** 2)[:h].sum()
        )
        if node_lb >= best - thresh:
            continue
        # split the larger uncertainty dimension
        if 2.0 * np.sin(min(_SQRT3 * r_s, math.pi) / 2.0) * norms.mean() >= g_t:
            for o in _OCT:
                c = r_c + o * r_s / 2.0
                if np.linalg.norm(c) - _SQRT3 * r_s / 2.0 <= math.pi:
                    heapq.heappush(
                        heap, (node_lb, next(cnt), c, r_s / 2.0, t_c, t_s)
                    )
        else:
            for o in _OCT:
                heapq.heappush(
                    heap,
                    (node_lb, next(cnt), r_c, r_s, t_c + o * t_s / 2.0, t_s / 2.0),
                )
    return best, best_pose[0], best_pose[1]
