"""Dense distance field over the target cloud (the BnB hot-path backend).

Replaces both reference NN-field structures with one device-resident module:

- fgoicp's ``NearestNeighborLUT`` — n^3 brute-forced squared distances in a
  CUDA 3D texture with hardware trilinear interpolation
  (``src/fgoicp/registration.cu:179-296``), which silently assumes clouds are
  pre-normalized to ``[0,1]^3`` (cell center = ``idx*definition``, no origin);
- jly's ``DT3D`` — CPU vector distance transform on a 300^3 grid
  (``src/goicp/jly_3ddt.cpp:710-742,889-1026``).

Here the grid carries an explicit ``origin``/``cell`` (fixing the [0,1]^3
assumption), and two build paths:

- ``method="brute"``: exact min squared distance from every cell center to
  the *true* target points (same semantics as ``buildLUTKernel``,
  ``registration.cu:238-258``), recast as x-slab scans whose inner distance
  computation is a matmul (instead of the thread-per-cell CUDA loop).
- ``method="edt"``: rasterize targets to the grid, then exact-to-the-raster
  squared EDT via three separable min-plus (tropical) transforms — the
  Felzenszwalb/Huttenlocher decomposition of what jly's 2-sweep vector DT
  approximates.  O(n^4) independent of target count.

Queries outside the domain get an *escape distance* correction by the
triangle inequality (the CUDA texture just clamps; jly adds a similar
correction at ``jly_3ddt.cpp:991-1025``): with ``c`` the clamped query,
``d(q,T) in [max(d(c)-|q-c|, 0), d(c)+|q-c|]``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class DistanceGrid:
    """Squared-distance field ``values[ix, iy, iz]`` sampled at cell centers
    ``origin + (idx + 0.5) * cell``.  Optionally carries ``indices`` — the
    nearest target-point index per cell (for grid-accelerated ICP
    correspondences, replacing the flattened k-d tree of
    ``src/icp_kernel.cu:281-377``).  ``raster_err``: worst-case distance
    between the field's effective target set and the true targets (0 for the
    exact brute build; half the cell diagonal for the rasterized EDT build)."""

    values: Any      # [n, n, n] f32 squared distances
    origin: Any      # [3]
    cell: Any        # scalar
    indices: Any = None  # [n, n, n] int32 or None
    raster_err: float = 0.0

    @property
    def n(self) -> int:
        return self.values.shape[0]


jax.tree_util.register_pytree_node(
    DistanceGrid,
    lambda g: ((g.values, g.origin, g.cell, g.indices), (g.raster_err,)),
    lambda aux, c: DistanceGrid(*c, raster_err=aux[0]),
)


def grid_domain(
    targets: np.ndarray, expand: float = 2.0, cover: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, float]:
    """Cubic domain: target bbox, cube-ified, expanded by ``expand`` about its
    center (jly cube-ifies and uses ``expandFactor=2``, ``jly_3ddt.cpp:889``).
    ``cover`` optionally adds points the domain must also contain (e.g. the
    translation search cube corners).  Returns ``(origin [3], side)``."""
    t = np.asarray(targets)
    lo, hi = t.min(0), t.max(0)
    center = (lo + hi) / 2
    side = float((hi - lo).max()) * expand
    if side <= 0.0:
        # degenerate cloud (single point / coincident points): a zero-sized
        # domain would give cell=0 and NaN lookups everywhere
        side = max(1e-3, 2e-3 * float(np.abs(center).max()), 1.0e-3)
    if cover is not None:
        c = np.asarray(cover).reshape(-1, 3)
        side = max(
            side, float(2.0 * np.abs(c - center).max()) * 1.001
        )
    origin = center - side / 2
    return origin.astype(np.float32), side


@functools.partial(jax.jit, static_argnames=("n", "with_index", "slab"))
def _build_brute(targets, origin, cell, n: int, with_index: bool, slab: int = 4):
    """Exact build: scan over x-slabs; distances via |q|^2-2qt+|t|^2 matmuls."""
    tn = jnp.sum(targets * targets, axis=1)  # [Nt]

    iy = jax.lax.broadcasted_iota(jnp.int32, (slab, n, n), 1)
    iz = jax.lax.broadcasted_iota(jnp.int32, (slab, n, n), 2)
    dix = jax.lax.broadcasted_iota(jnp.int32, (slab, n, n), 0)

    def body(ix0, _):
        ix = dix + ix0 * slab
        cells = (
            origin[None, None, None, :]
            + (jnp.stack([ix, iy, iz], axis=-1).astype(jnp.float32) + 0.5) * cell
        ).reshape(-1, 3)  # [slab*n*n, 3]
        qn = jnp.sum(cells * cells, axis=1)
        dots = jnp.dot(
            cells, targets.T, precision=jax.lax.Precision.HIGHEST
        )  # [slab*n*n, Nt]
        d2 = qn[:, None] - 2.0 * dots + tn[None, :]
        vals = jnp.maximum(jnp.min(d2, axis=1), 0.0).reshape(slab, n, n)
        if with_index:
            idxs = jnp.argmin(d2, axis=1).astype(jnp.int32).reshape(slab, n, n)
        else:
            idxs = jnp.zeros((slab, n, n), jnp.int32)
        return ix0 + 1, (vals, idxs)

    _, (values, indices) = jax.lax.scan(body, 0, None, length=n // slab)
    values = values.reshape(n, n, n)
    indices = indices.reshape(n, n, n)
    return values, (indices if with_index else None)


def _pick_chunk(n: int, want: int = 16) -> int:
    for c in range(min(want, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def _minplus_axis(D, I, c2, axis: int, chunk: Optional[int] = None):
    """Tropical (min-plus) transform along ``axis``:
    ``D'[i] = min_j D[j] + c2*(i-j)^2``, with argmin payload carry ``I``.

    Tiled over output columns: each ``lax.scan`` step produces ``chunk``
    output planes from the full input — pure elementwise adds/mins over
    tiles, no gathers, no matmuls.
    """
    n = D.shape[axis]
    if chunk is None:
        chunk = _pick_chunk(n)
    D = jnp.moveaxis(D, axis, -1)  # [..., n]
    I = jnp.moveaxis(I, axis, -1)
    j = jnp.arange(n, dtype=D.dtype)

    def body(_, i0):
        i = i0 * chunk + jnp.arange(chunk, dtype=D.dtype)  # output columns
        C = c2 * (j[:, None] - i[None, :]) ** 2            # [n, chunk]
        cand = D[..., :, None] + C                          # [..., n, chunk]
        amin = jnp.argmin(cand, axis=-2)                    # [..., chunk]
        best = jnp.min(cand, axis=-2)
        bidx = jnp.take_along_axis(I, amin, axis=-1)
        return None, (best, bidx)

    _, (best, bidx) = jax.lax.scan(
        body, None, jnp.arange(n // chunk, dtype=D.dtype)
    )
    # scan stacks on axis 0: [n//chunk, ..., chunk] → [..., n]
    best = jnp.moveaxis(best, 0, -2).reshape(*D.shape[:-1], n)
    bidx = jnp.moveaxis(bidx, 0, -2).reshape(*D.shape[:-1], n)
    return jnp.moveaxis(best, -1, axis), jnp.moveaxis(bidx, -1, axis)


@functools.partial(jax.jit, static_argnames=("n", "with_index"))
def _build_edt(targets, origin, cell, n: int, with_index: bool = True):
    """Separable EDT of the rasterized target cloud.

    Targets rasterize to occupied cells (like ``jly_3ddt.cpp:911-923``); three
    min-plus passes then give the *exact* squared EDT to the occupied cell
    centers — the Felzenszwalb/Huttenlocher decomposition of what jly's
    2-sweep vector DT approximates.  Cost O(n^4) independent of target count
    (the brute build is O(n^3·Nt): hopeless for big clouds, and its K=3
    matmuls leave a matrix unit idle).  Accuracy vs. true points: half the cell
    diagonal (the accuracy class the reference notes at ``jly_3ddt.cpp:925``),
    recorded as ``raster_err`` so bound evaluation can stay conservative.
    Also returns per-cell nearest-target indices (payload-carried argmin).
    """
    idx = jnp.clip(
        jnp.floor((targets - origin[None, :]) / cell).astype(jnp.int32), 0, n - 1
    )
    flat = (idx[:, 0] * n + idx[:, 1]) * n + idx[:, 2]
    occ = jnp.full((n * n * n,), jnp.inf, jnp.float32)
    occ = occ.at[flat].set(0.0)
    D = occ.reshape(n, n, n)
    c2 = cell * cell
    if with_index:
        pid = jnp.zeros((n * n * n,), jnp.int32)
        pid = pid.at[flat].set(jnp.arange(targets.shape[0], dtype=jnp.int32))
        I = pid.reshape(n, n, n)
        for ax in range(3):
            D, I = _minplus_axis(D, I, c2, ax)
        return D, I
    I = jnp.zeros((1, 1, 1), jnp.int32)
    for ax in range(3):
        D, _ = _minplus_axis(D, D, c2, ax)
    return D, I


def build_distance_grid(
    targets,
    n: int = 256,
    expand: float = 2.0,
    cover=None,
    method: str = "brute",
    with_index: bool = False,
    domain: Optional[Tuple[np.ndarray, float]] = None,
) -> DistanceGrid:
    """Build the distance field over ``targets`` ``[Nt,3]``."""
    targets = jnp.asarray(targets, jnp.float32)
    if domain is None:
        domain = grid_domain(np.asarray(targets), expand, cover)
    origin, side = domain
    cell = jnp.float32(side / n)
    origin = jnp.asarray(origin, jnp.float32)
    raster_err = 0.0
    if method == "brute":
        slab = 4 if n % 4 == 0 else 1
        values, indices = _build_brute(targets, origin, cell, n, with_index, slab)
    elif method == "edt":
        values, indices = _build_edt(targets, origin, cell, n, with_index)
        raster_err = float(cell) * math.sqrt(3.0) / 2.0
        if not with_index:
            indices = None
    else:
        raise ValueError(f"unknown grid build method {method!r}")
    return DistanceGrid(
        values=values,
        origin=origin,
        cell=cell,
        indices=indices,
        raster_err=raster_err,
    )


def _clamped_cell_coords(grid: DistanceGrid, queries):
    """Continuous cell coordinates (centered convention) + escape distance."""
    n = grid.n
    x = (queries - grid.origin) / grid.cell - 0.5  # cell-center coords
    xc = jnp.clip(x, 0.0, n - 1.0)
    # escape: distance from query to the clamped lookup position
    esc = jnp.sqrt(jnp.sum(((x - xc) * grid.cell) ** 2, axis=-1))
    return xc, esc


def lookup_sq_nearest(grid: DistanceGrid, queries):
    """Nearest-cell squared distance + escape: ≙ jly ``dt.Distance``
    (no interpolation, ``jly_3ddt.cpp:981-989``)."""
    xc, esc = _clamped_cell_coords(grid, queries)
    idx = jnp.clip(jnp.round(xc).astype(jnp.int32), 0, grid.n - 1)
    flat = (idx[..., 0] * grid.n + idx[..., 1]) * grid.n + idx[..., 2]
    vals = jnp.take(grid.values.reshape(-1), flat, axis=0)
    return vals, esc


def lookup_sq_trilinear(grid: DistanceGrid, queries):
    """Trilinearly interpolated squared distance + escape: ≙ the CUDA
    texture fetch with ``cudaFilterModeLinear`` (``registration.cu:198,290-296``)."""
    n = grid.n
    xc, esc = _clamped_cell_coords(grid, queries)
    x0 = jnp.floor(xc)
    f = xc - x0
    i0 = jnp.clip(x0.astype(jnp.int32), 0, n - 1)
    i1 = jnp.clip(i0 + 1, 0, n - 1)
    flatv = grid.values.reshape(-1)

    def at(ix, iy, iz):
        return jnp.take(flatv, (ix * n + iy) * n + iz, axis=0)

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c000 = at(i0[..., 0], i0[..., 1], i0[..., 2])
    c100 = at(i1[..., 0], i0[..., 1], i0[..., 2])
    c010 = at(i0[..., 0], i1[..., 1], i0[..., 2])
    c110 = at(i1[..., 0], i1[..., 1], i0[..., 2])
    c001 = at(i0[..., 0], i0[..., 1], i1[..., 2])
    c101 = at(i1[..., 0], i0[..., 1], i1[..., 2])
    c011 = at(i0[..., 0], i1[..., 1], i1[..., 2])
    c111 = at(i1[..., 0], i1[..., 1], i1[..., 2])
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz, esc


def lookup_index(grid: DistanceGrid, queries):
    """Nearest target-point index via the index grid (grid-ICP path)."""
    if grid.indices is None:
        raise ValueError("grid built without with_index=True")
    xc, _ = _clamped_cell_coords(grid, queries)
    idx = jnp.clip(jnp.round(xc).astype(jnp.int32), 0, grid.n - 1)
    flat = (idx[..., 0] * grid.n + idx[..., 1]) * grid.n + idx[..., 2]
    return jnp.take(grid.indices.reshape(-1), flat, axis=0)


def distance_bounds(grid: DistanceGrid, queries, lookup: str = "trilinear"):
    """Per-query conservative distance interval ``(d_lo, d_hi)``.

    The interval accounts for the lookup's lattice discretization error
    (the field is exact only at cell centers; d is 1-Lipschitz) and the
    build's rasterization error, so ``d_lo ≤ true ≤ d_hi`` holds
    unconditionally — unlike the reference's single fetched value
    (``registration.cu:48-50``), which silently carries both errors.
    Outside the domain the escape correction applies the triangle
    inequality instead of silently clamping.  (``bnb.bounds`` uses the raw
    lookups + ``lattice_slack`` directly instead of this helper, applying
    the same correction at its own layer.)
    """
    if lookup == "trilinear":
        val, esc = lookup_sq_trilinear(grid, queries)
        lat = grid.cell * np.sqrt(3.0)
    elif lookup == "nearest":
        val, esc = lookup_sq_nearest(grid, queries)
        lat = grid.cell * (np.sqrt(3.0) / 2.0)
    else:
        raise ValueError(f"unknown lookup {lookup!r}")
    slack = lat + grid.raster_err
    d = jnp.sqrt(jnp.maximum(val, 0.0))
    return jnp.maximum(d - esc - slack, 0.0), d + esc + slack
