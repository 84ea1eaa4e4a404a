"""Multi-chip scaling: mesh + ``shard_map`` over cube and point axes.

The reference is a single-process, single-GPU program (SURVEY §2 parallelism
inventory); its only concurrency is 32 CUDA streams of width-1 translation
batches (``fgoicp.hpp:24``, ``registration.cu:109-120``) and a render/solver
thread pair.  This framework scales along the two axes that exist in this
workload:

- **cube axis** (the PP/EP analogue): the flat job batch of (rotation,
  translation-cube) bound evaluations is sharded across devices — each chip
  evaluates a slice of the frontier;
- **point axis** (the DP/SP analogue): the source cloud is sharded; per-job
  SSE/bound sums become ``psum`` reductions.

Both are expressed with ``jax.sharding.Mesh`` + ``shard_map``; XLA inserts
the collectives.  1 chip → N chips is a mesh-shape change only.

Trimmed reductions across the point shard use a two-stage selection: the
global ``k`` largest residuals are contained in the union of each shard's
``k`` largest, so a shard-local ``top_k`` + ``all_gather`` + global ``top_k``
reproduces the exact trimmed sum with ``P·k`` traffic instead of ``N``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from goicp_tpu.geo.procrustes import procrustes
from goicp_tpu.geo.rotation import rotation_displacement
from goicp_tpu.nn.grid import DistanceGrid, lookup_sq_nearest, lookup_sq_trilinear

_SQRT3 = math.sqrt(3.0)
_PREC = jax.lax.Precision.HIGHEST


def make_mesh(n_cubes: int = 1, n_points: int = 1, devices=None) -> Mesh:
    """Device mesh with named axes ``("cubes", "points")``."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_cubes * n_points, (
        f"need {n_cubes * n_points} devices, have {devices.size}"
    )
    grid = devices[: n_cubes * n_points].reshape(n_cubes, n_points)
    return Mesh(grid, axis_names=("cubes", "points"))


def _local_distance(grid: DistanceGrid, pts, lookup: str):
    if lookup == "trilinear":
        val, esc = lookup_sq_trilinear(grid, pts)
    else:
        val, esc = lookup_sq_nearest(grid, pts)
    return jnp.sqrt(jnp.maximum(val, 0.0)), esc


def _psum_trimmed(x, drop: int, axis_name: str):
    """Trimmed sum over a sharded axis: global sum minus the ``drop``
    largest entries (exact two-stage distributed selection)."""
    total = jax.lax.psum(jnp.sum(x, axis=-1), axis_name)
    if drop <= 0:
        return total
    k = min(drop, x.shape[-1])
    local_top = jax.lax.top_k(x, k)[0]                      # [..., k]
    gathered = jax.lax.all_gather(local_top, axis_name, axis=-1, tiled=True)
    global_top = jax.lax.top_k(gathered, drop)[0]           # [..., drop]
    return total - jnp.sum(global_top, axis=-1)


def sharded_bounds_step(
    mesh: Mesh,
    grid: DistanceGrid,
    *,
    trim_drop: int = 0,
    lookup: str = "trilinear",
    slack: float = 0.0,
):
    """Build the sharded bound-evaluation step.

    Returns a jitted ``step(src, norms, R, max_angle, t_center, t_span,
    rot_flag, mask) -> (center_val, node_lb)`` where ``src [N,3]`` is sharded
    over ``points``, jobs ``[M,...]`` over ``cubes``, outputs ``[M]``
    replicated over ``points``.  Single-chip semantics identical to
    ``bnb.bounds.BoundsEvaluator._step_impl``.
    """

    def kernel(src, norms, R, max_angle, t_center, t_span, rot_flag, mask):
        # src: [N/p, 3] local shard; R: [M/c, 3, 3] local shard
        pts = (
            jnp.einsum("mij,nj->mni", R, src, precision=_PREC)
            + t_center[:, None, :]
        )
        d, esc = _local_distance(grid, pts, lookup)
        d_lo = jnp.maximum(d - esc - slack, 0.0)
        d_hi = d + esc + slack
        gamma_r = rotation_displacement(max_angle, norms) * rot_flag[:, None]
        gamma_t = (_SQRT3 * t_span)[:, None]
        center_d = jnp.where(rot_flag[:, None] > 0, d_lo, d_hi)
        center_c = jnp.maximum(center_d - gamma_r, 0.0) ** 2
        lb_c = jnp.maximum(d_lo - gamma_r - gamma_t, 0.0) ** 2
        center_val = _psum_trimmed(center_c, trim_drop, "points")
        node_lb = _psum_trimmed(lb_c, trim_drop, "points")
        inf = jnp.float32(np.inf)
        return (
            jnp.where(mask, center_val, inf),
            jnp.where(mask, node_lb, inf),
        )

    jobs = P("cubes")
    step = jax.jit(
        jax.shard_map(
            kernel,
            mesh=mesh,
            in_specs=(
                P("points", None),   # src
                P("points"),         # norms
                P("cubes", None, None),
                jobs,                # max_angle
                P("cubes", None),    # t_center
                jobs,                # t_span
                jobs,                # rot_flag
                jobs,                # mask
            ),
            out_specs=(jobs, jobs),
            # all_gather+top_k trimmed reductions are replicated over
            # 'points' but the VMA checker cannot infer it
            check_vma=False,
        )
    )
    return step


def sharded_sse(mesh: Mesh, grid: DistanceGrid, *, trim_drop: int = 0, lookup: str = "trilinear"):
    """Point-sharded (trimmed) SSE at a batch of poses, cube-sharded."""
    step = sharded_bounds_step(mesh, grid, trim_drop=trim_drop, lookup=lookup)

    def sse(src, norms, R, t):
        B = R.shape[0]
        z = jnp.zeros((B,), jnp.float32)
        cv, _ = step(src, norms, R, z, t, z, z, jnp.ones((B,), bool))
        return cv

    return sse


def sharded_evaluate_se3(
    mesh: Mesh,
    grid: DistanceGrid,
    *,
    trim_drop: int = 0,
    lookup: str = "nearest",
    slack: float = 0.0,
):
    """Sharded SE(3) node evaluation: the multi-chip form of
    ``bnb.se3.evaluate_se3_nodes`` — nodes over the ``cubes`` axis, source
    points over ``points`` with ``psum``-reduced (trimmed) bound sums.

    Returns ``step(src, norms, R, max_angle, t_c, t_span, mask) -> (ub, lb)``.
    """

    def kernel(src, norms, R, max_angle, t_c, t_span, mask):
        pts = (
            jnp.einsum("mij,nj->mni", R, src, precision=_PREC)
            + t_c[:, None, :]
        )
        d, esc = _local_distance(grid, pts, lookup)
        d_lo = jnp.maximum(d - esc - slack, 0.0)
        d_hi = d + esc + slack
        gamma_r = rotation_displacement(max_angle, norms)
        gamma_t = (_SQRT3 * t_span)[:, None]
        ub_c = d_hi**2
        lb_c = jnp.maximum(d_lo - gamma_r - gamma_t, 0.0) ** 2
        ub = _psum_trimmed(ub_c, trim_drop, "points")
        lb = _psum_trimmed(lb_c, trim_drop, "points")
        inf = jnp.float32(np.inf)
        return jnp.where(mask, ub, inf), jnp.where(mask, lb, inf)

    jobs = P("cubes")
    return jax.jit(
        jax.shard_map(
            kernel,
            mesh=mesh,
            in_specs=(
                P("points", None),
                P("points"),
                P("cubes", None, None),
                jobs,
                P("cubes", None),
                jobs,
                jobs,
            ),
            out_specs=(jobs, jobs),
            check_vma=False,
        )
    )


def sharded_icp_step(mesh: Mesh, grid: DistanceGrid, targets, *, trim_drop: int = 0):
    """One sharded ICP iteration over a batch of poses.

    Poses ``[B]`` are sharded over ``cubes``; source points over ``points``.
    Correspondences come from the grid index field (local gather); the
    Procrustes normal-equation sums (weighted centroids + cross-covariance)
    are ``psum``-reduced over the point shard — the distributed counterpart
    of the thrust reductions at ``icp3d.cu:152-166``.
    """
    targets = jnp.asarray(targets, jnp.float32)
    flat_idx = grid.indices.reshape(-1)

    def kernel(src, R, t):
        # src: [N/p, 3]; R: [B/c, 3, 3]; t: [B/c, 3]
        pts = jnp.einsum("bij,nj->bni", R, src, precision=_PREC) + t[:, None, :]
        n = grid.n
        x = jnp.clip((pts - grid.origin) / grid.cell - 0.5, 0.0, n - 1.0)
        idx = jnp.round(x).astype(jnp.int32)
        flat = (idx[..., 0] * n + idx[..., 1]) * n + idx[..., 2]
        nn_idx = jnp.take(flat_idx, flat, axis=0)
        dst = jnp.take(targets, nn_idx, axis=0)          # [B/c, N/p, 3]
        diff = pts - dst
        d2 = jnp.sum(diff * diff, axis=-1)

        if trim_drop > 0:
            k = min(trim_drop, d2.shape[-1])
            local_top = jax.lax.top_k(d2, k)[0]
            gathered = jax.lax.all_gather(local_top, "points", axis=-1, tiled=True)
            thresh = jax.lax.top_k(gathered, trim_drop)[0][..., -1:]
            w = (d2 < thresh).astype(d2.dtype)
        else:
            w = jnp.ones_like(d2)

        # weighted Procrustes with psum-reduced moments
        wsum = jax.lax.psum(jnp.sum(w, axis=-1, keepdims=True), "points")
        wsum = jnp.maximum(wsum, 1e-30)
        mu_s = jax.lax.psum(jnp.sum(pts * w[..., None], axis=-2), "points") / wsum
        mu_d = jax.lax.psum(jnp.sum(dst * w[..., None], axis=-2), "points") / wsum
        a = pts - mu_s[..., None, :]
        b = dst - mu_d[..., None, :]
        C = jax.lax.psum(
            jnp.einsum("bni,bnj->bij", a * w[..., None], b, precision=_PREC),
            "points",
        )
        from goicp_tpu.geo.procrustes import horn_quaternion
        from goicp_tpu.geo.rotation import quat_to_matrix

        q = horn_quaternion(C)
        R_d = quat_to_matrix(q)
        t_d = mu_d - jnp.einsum("bij,bj->bi", R_d, mu_s, precision=_PREC)
        # compose: new = delta ∘ old (icp3d.cu:99-100)
        R_new = jnp.einsum("bij,bjk->bik", R_d, R, precision=_PREC)
        t_new = jnp.einsum("bij,bj->bi", R_d, t, precision=_PREC) + t_d
        sse = jax.lax.psum(jnp.sum(d2 * w, axis=-1), "points")
        return R_new, t_new, sse

    return jax.jit(
        jax.shard_map(
            kernel,
            mesh=mesh,
            in_specs=(P("points", None), P("cubes", None, None), P("cubes", None)),
            out_specs=(P("cubes", None, None), P("cubes", None), P("cubes")),
            check_vma=False,
        )
    )
