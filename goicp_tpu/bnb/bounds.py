"""Fused BnB bound evaluation — the hot path of the global solver.

Batched recast of ``kernComputeBounds`` + per-stream thrust reduces
(``src/fgoicp/registration.cu:27-60,88-151``).  Where the reference evaluates
**one** translation node per kernel launch on one of 32 streams, here a flat
batch of ``M`` *jobs* — (rotation, translation cube, with/without rotation
uncertainty) triples — is evaluated in one jitted device step:

    transform  [M,N,3]  (einsum, full f32)
 →  distance-field lookup  [M,N]  (trilinear gather ≙ tex3D)
 →  uncertainty-deflated clamp + square  (elementwise, fused by XLA)
 →  (trimmed) row reductions → center value + node lower bound  [M]

Correctness upgrades over the reference (SURVEY §2 C17 notes):

- rotation uncertainty uses the *correct* per-point radius
  ``2 sin(min(θ,π)/2)·‖p‖`` (``jly_goicp.cpp:153-159`` semantics) instead of
  the squared-norm heuristic with the in-code TODO (``registration.cu:39-43``);
- out-of-domain queries get triangle-inequality escape bounds instead of the
  texture clamp;
- an optional *lattice slack* accounts for the distance-field discretization
  (cell-diagonal error the reference acknowledges at ``jly_3ddt.cpp:925`` but
  ignores), making lower bounds certifiably valid;
- upper-bound sums use ``d_hi`` so the incumbent error is a true upper bound
  (never prunes the optimum away).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.geo.rotation import rotation_displacement
from goicp_tpu.nn.grid import (
    DistanceGrid,
    lookup_sq_nearest,
    lookup_sq_trilinear,
)

_SQRT3 = math.sqrt(3.0)
_PREC = jax.lax.Precision.HIGHEST


def lattice_slack(grid: DistanceGrid, lookup: str) -> float:
    """Worst-case |grid distance − true distance| inside the domain.

    The field is exact at cell centers (w.r.t. its effective target set) and
    ``d`` is 1-Lipschitz, so nearest-cell lookup errs by at most half the
    cell diagonal and trilinear interpolation of ``d²`` (concave sqrt →
    Jensen) by at most the full cell diagonal; an EDT-built field adds its
    rasterization Hausdorff error ``grid.raster_err``.
    """
    cell = float(grid.cell)
    interp = cell * _SQRT3 * (1.0 if lookup == "trilinear" else 0.5)
    return interp + float(grid.raster_err)


def _trimmed_row_sum(x, h: int):
    """Sum of the ``h`` smallest entries per row: ``x [M,N] → [M]``.

    ≙ the ``intro_select`` partial sort of ``jly_goicp.cpp:298,366`` /
    ``jly_sorting.hpp:229``.  Computed as ``sum − top_k(N−h)`` when the
    discard side is smaller (the usual case: trim fractions ≤ 0.5).
    """
    n = x.shape[-1]
    if h >= n:
        return jnp.sum(x, axis=-1)
    drop = n - h
    if drop <= h:
        worst = jax.lax.top_k(x, drop)[0]
        return jnp.sum(x, axis=-1) - jnp.sum(worst, axis=-1)
    best = -jax.lax.top_k(-x, h)[0]
    return jnp.sum(best, axis=-1)


@functools.partial(jax.jit, static_argnames=("h", "lookup"))
def bounds_step(
    src, norms, grid, slack, R, max_angle, t_center, t_span, rot_flag, mask,
    *, h: int, lookup: str,
):
    """The fused device step.  All job inputs ``[M,...]``; returns
    ``(center_val, node_lb) [M]``.

    ``center_val``: objective evaluated at the cube center — the plain SSE
    when ``rot_flag=0`` (an *upper* bound path, uses ``d_hi``), or the
    rotation-deflated SSE when ``rot_flag=1`` (a *lower* bound path, uses
    ``d_lo``).  ``node_lb``: additionally deflated by the translation radius
    ``√3·span`` — the cube's lower bound (≙ ``registration.cu:48-56``).

    Module-level jit with traced ``(src, grid, slack)``: solver instances for
    same-shaped problems share one compiled executable (the reference pays a
    cudaMalloc/cudaFree + kernel launch per call, ``registration.cu:97-148``).
    """
    pts = (
        jnp.einsum("mij,nj->mni", R, src, precision=_PREC)
        + t_center[:, None, :]
    )  # [M,N,3]
    if lookup == "trilinear":
        val, esc = lookup_sq_trilinear(grid, pts)
    else:
        val, esc = lookup_sq_nearest(grid, pts)
    d = jnp.sqrt(jnp.maximum(val, 0.0))
    d_lo = jnp.maximum(d - esc - slack, 0.0)       # ≤ true distance
    d_hi = d + esc + slack                          # ≥ true distance
    gamma_r = rotation_displacement(max_angle, norms) * rot_flag[:, None]
    gamma_t = (_SQRT3 * t_span)[:, None]

    center_d = jnp.where(rot_flag[:, None] > 0, d_lo, d_hi)
    center_c = jnp.maximum(center_d - gamma_r, 0.0) ** 2
    lb_c = jnp.maximum(d_lo - gamma_r - gamma_t, 0.0) ** 2
    center_val = _trimmed_row_sum(center_c, h)
    node_lb = _trimmed_row_sum(lb_c, h)
    inf = jnp.float32(np.inf)
    center_val = jnp.where(mask, center_val, inf)
    node_lb = jnp.where(mask, node_lb, inf)
    return center_val, node_lb


class BoundsEvaluator:
    """Bound evaluator bound to one (source, grid) pair.

    ≙ the ``Registration`` object of ``registration.hpp:44-99`` (owns the
    uploaded clouds + LUT and exposes ``compute_sse_error``).
    """

    def __init__(
        self,
        src,
        grid: DistanceGrid,
        *,
        trim_fraction: float = 0.0,
        lookup: str = "trilinear",
        conservative: bool = True,
    ):
        self.src = jnp.asarray(src, jnp.float32)          # [N,3]
        self.norms = jnp.linalg.norm(self.src, axis=-1)    # ≙ normData, jly_goicp.cpp:142
        self.grid = grid
        self.n_points = int(self.src.shape[0])
        self.trim_fraction = float(trim_fraction)
        self.h = max(1, int(round(self.n_points * (1.0 - self.trim_fraction))))
        self.lookup = lookup
        self.slack = lattice_slack(grid, lookup) if conservative else 0.0

    def _step_impl(self, R, max_angle, t_center, t_span, rot_flag, mask):
        """Closure form of :func:`bounds_step` (driver compile-check entry)."""
        return bounds_step(
            self.src, self.norms, self.grid, jnp.float32(self.slack),
            R, max_angle, t_center, t_span, rot_flag, mask,
            h=self.h, lookup=self.lookup,
        )

    # ---- host-facing API -------------------------------------------------

    def evaluate(self, R, max_angle, t_center, t_span, rot_flag, mask):
        """Evaluate a padded job batch; returns numpy ``(center_val, node_lb)``."""
        cv, lb = bounds_step(
            self.src,
            self.norms,
            self.grid,
            jnp.float32(self.slack),
            jnp.asarray(R, jnp.float32),
            jnp.asarray(max_angle, jnp.float32),
            jnp.asarray(t_center, jnp.float32),
            jnp.asarray(t_span, jnp.float32),
            jnp.asarray(rot_flag, jnp.float32),
            jnp.asarray(mask),
            h=self.h,
            lookup=self.lookup,
        )
        return np.asarray(cv), np.asarray(lb)

    def sse_at(self, R, t) -> np.ndarray:
        """Plain (trimmed) SSE at exact poses ``[B]`` via the grid
        (≙ ``compute_sse_error(R,t)``, ``registration.cu:62-86``)."""
        R = np.asarray(R, np.float32).reshape(-1, 3, 3)
        t = np.asarray(t, np.float32).reshape(-1, 3)
        B = R.shape[0]
        zeros = np.zeros((B,), np.float32)
        cv, _ = self.evaluate(R, zeros, t, zeros, zeros, np.ones((B,), bool))
        return cv
