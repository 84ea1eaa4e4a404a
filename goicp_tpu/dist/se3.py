"""Multi-chip SE(3) BnB rounds: the solver hot path over a device mesh.

The reference's only concurrency over bound evaluations is a 32-stream pool
of width-1 translation batches (``fgoicp.hpp:24``, ``registration.cu:109-120``).
This module generalizes that axis to a ``("cubes", "points")`` device mesh
(SURVEY §2 parallelism checklist):

- **cubes**: each round's flat job batch of SE(3) nodes is sharded across
  devices — every chip evaluates a slice of the frontier pops;
- **points**: the source cloud is sharded; every per-node bound reduction
  (plain and trimmed) becomes a ``psum``/``pmax`` collective.

The round returns *globally* reduced results: the incumbent candidates
(min-ub node, ICP-refined top-k) are computed on the logical ``[M]`` arrays
after the ``shard_map`` region, so XLA inserts the cross-device argmin /
gather — the incumbent "all-reduce" of a distributed BnB.  Frontier balance
is by construction in the single-controller design: the host pops the global
best ``8·B`` nodes each round and splits them evenly over the ``cubes`` axis,
i.e. the frontier is rebalanced *every* round (a multi-host deployment
slices pops per host the same way — ``multipair.register_pairs`` documents
the per-host slicing convention).

Backends mirror ``bnb.se3``: "exact"/"grid" are the XLA tile-scan bound
kernels with point-shard psum epilogues; "mxu" runs the per-point Pallas
kernel (``nn.mxu.min_d2_nodes``) per (node-shard × point-shard) block;
"screen" runs the fused screened kernel per cube shard — ``shard_map`` is
the idiomatic way to run a Pallas kernel SPMD.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from goicp_tpu.bnb.device_inner import _exact_min_d2, _gather_d2
from goicp_tpu.core.types import RigidTransform
from goicp_tpu.geo.rotation import rotation_displacement

_SQRT3 = math.sqrt(3.0)
_PREC = jax.lax.Precision.HIGHEST
_INF = np.float32(np.inf)  # numpy on purpose — see bnb.device_inner._INF


def pad_points(src: np.ndarray, norms: np.ndarray, n_points: int, quantum: int):
    """Pad the solve cloud so the point axis splits evenly over ``n_points``
    shards of ``quantum``-aligned length.  Padded rows are zeros (their
    bound contributions are masked by ``n_valid`` inside the kernel)."""
    n = src.shape[0]
    step = n_points * quantum
    n_pad = ((n + step - 1) // step) * step
    if n_pad == n:
        return np.asarray(src, np.float32), np.asarray(norms, np.float32)
    src_p = np.zeros((n_pad, 3), np.float32)
    src_p[:n] = src
    norms_p = np.zeros((n_pad,), np.float32)
    norms_p[:n] = norms
    return src_p, norms_p


def _trimmed_sum_bisect_psum(x, h: int, upper: bool, axis_name: str,
                             iters: int = 24):
    """Point-shard-distributed form of ``bnb.se3._trimmed_sum_bisect``: the
    same value-threshold bisection, with every row reduction ``psum``-reduced
    over ``axis_name``.  Identical iteration count → identical thresholds →
    the same upper/lower-sided trimmed sums as the single-chip path (modulo
    f32 reassociation)."""
    rowmax = jax.lax.pmax(
        jnp.max(jnp.where(x < 1e29, x, 0.0), axis=-1), axis_name
    )
    lo = jnp.zeros_like(rowmax)
    hi = rowmax + 1e-12

    def body(carry, _):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        cnt = jax.lax.psum(
            jnp.sum((x <= mid[:, None]).astype(jnp.float32), axis=-1),
            axis_name,
        )
        take = cnt >= h
        return (jnp.where(take, lo, mid), jnp.where(take, mid, hi)), None

    (lo, hi), _ = jax.lax.scan(body, (lo, hi), None, length=iters)
    sel = x <= lo[:, None]
    S = jax.lax.psum(jnp.sum(jnp.where(sel, x, 0.0), axis=-1), axis_name)
    C = jax.lax.psum(jnp.sum(sel.astype(jnp.float32), axis=-1), axis_name)
    rem = jnp.maximum(h - C, 0.0)
    return S + rem * (hi if upper else lo)


@functools.lru_cache(maxsize=32)
def make_sharded_se3_round(
    mesh: Mesh,
    *,
    h: int,
    n_valid: int,
    lookup: str,
    backend: str,
    tile: int,
    refine_k: int,
    icp_params,
    icp_backend: str,
):
    """Build the jitted multi-chip round: sharded bound evaluation + global
    top-k batched ICP refinement, one dispatch (the mesh form of
    ``bnb.se3.se3_round``; ≙ ``kernComputeBounds``+reduce over 32 streams,
    ``registration.cu:88-151``, widened to a device mesh).

    Returned callable: ``round(src_pad, norms_pad, grid, tgt, slack, thresh,
    R, max_angle, t_c, t_span, mask, src) -> (ub, lb, R_ref, t_ref, sse_ref,
    iters)`` with job arrays ``[M]`` (M divisible by the cubes extent) and
    ``src_pad`` point-padded via :func:`pad_points`.  ``thresh`` (incumbent
    − ε at dispatch) drives the "screen" backend — the fused screened kernel
    runs per cube shard when the point axis is unsharded (points extent 1;
    otherwise screen falls back to "mxu", since a point shard's partial sum
    cannot be compared against the global threshold).

    ``h``: trimmed keep-count (0 = untrimmed); ``n_valid``: real source
    count inside the padded cloud.
    """
    drop = 0 if h in (0, n_valid) else n_valid - h
    from goicp_tpu.nn import mxu as _mxu

    if backend == "screen" and (mesh.shape["points"] != 1 or drop):
        # the progressive screen compares PARTIAL point sums against the
        # global threshold — invalid on a point shard (a shard's partial sum
        # bounds only its slice) and for trimmed sums.  Untrimmed cube-only
        # meshes screen per shard.
        backend = "mxu"

    if backend == "screen":

        def kernel(src_pad, norms_pad, grid, tgt, slack, thresh,
                   R, max_angle, t_c, t_span, mask):
            # whole cloud per shard (points extent 1): the fused screened
            # kernel evaluates this device's node slice exactly as the
            # single-chip engine would — thresholds are globally valid
            # because the incumbent only improves (FUTURE lever 8)
            from goicp_tpu.bnb.se3 import evaluate_se3_nodes_screened

            src = jax.lax.slice_in_dim(src_pad, 0, n_valid, axis=0)
            norms = jax.lax.slice_in_dim(norms_pad, 0, n_valid, axis=0)
            return evaluate_se3_nodes_screened(
                src, norms, tgt, slack, thresh,
                R, max_angle, t_c, t_span, mask, h=h,
            )

    elif backend == "mxu":

        def kernel(src_pad, norms_pad, grid, tgt, slack, thresh,
                   R, max_angle, t_c, t_span, mask):
            # local shards: src_pad [Nl,3], R [Ml,3,3]; tgt replicated
            nl = src_pad.shape[0]
            d2 = _mxu.min_d2_nodes(src_pad, tgt, R, t_c)[:, :nl]
            return _deflate_reduce(
                d2, src_pad, norms_pad, slack, max_angle, t_span, mask
            )

    else:

        def kernel(src_pad, norms_pad, grid, tgt, slack, thresh,
                   R, max_angle, t_c, t_span, mask):
            nl = src_pad.shape[0]
            n_tiles = nl // tile
            src_t = src_pad.reshape(n_tiles, tile, 3)
            if backend == "exact":
                tgt_tiles = tgt.reshape(-1, 256, 3)
                tgt_norm_tiles = jnp.sum(tgt_tiles * tgt_tiles, axis=-1)

            def tile_body(_, s_tile):
                pts = (
                    jnp.einsum("mij,tj->mti", R, s_tile, precision=_PREC)
                    + t_c[:, None, :]
                )
                if backend == "exact":
                    d2 = _exact_min_d2(pts, tgt_tiles, tgt_norm_tiles)
                    esc = jnp.zeros_like(d2)     # exact: no grid escape term
                else:
                    d2, esc = _gather_d2(grid, pts, lookup)
                return None, (d2, esc)

            _, (d2_t, esc_t) = jax.lax.scan(tile_body, None, src_t)
            M = R.shape[0]
            d2 = d2_t.swapaxes(0, 1).reshape(M, nl)
            esc = esc_t.swapaxes(0, 1).reshape(M, nl)
            return _deflate_reduce(
                d2, src_pad, norms_pad, slack, max_angle, t_span, mask,
                esc=esc,
            )

    def _deflate_reduce(d2, src_pad, norms_pad, slack, max_angle, t_span,
                        mask, esc=None):
        """Shared epilogue: Yang et al. eq. 10 deflation + (trimmed)
        reductions over the sharded point axis (≙ the thrust reduces at
        ``registration.cu:123-142``, as collectives)."""
        nl = src_pad.shape[0]
        d = jnp.sqrt(jnp.maximum(d2, 0.0))
        if esc is None:
            d_lo = jnp.maximum(d - slack, 0.0)
            d_hi = d + slack
        else:
            d_lo = jnp.maximum(d - esc - slack, 0.0)
            d_hi = d + esc + slack
        gamma_r = rotation_displacement(max_angle, norms_pad)   # [Ml, Nl]
        gamma_t = (_SQRT3 * t_span)[:, None]
        start = jax.lax.axis_index("points") * nl
        pmask = ((start + jnp.arange(nl)) < n_valid).astype(jnp.float32)[None]
        ub_c = (d_hi**2) * pmask
        lb_c = jnp.maximum(d_lo - gamma_r - gamma_t, 0.0) ** 2 * pmask
        if drop:
            inf_pad = (1.0 - pmask) * 1e30
            s_ub = _trimmed_sum_bisect_psum(
                ub_c + inf_pad, h, upper=True, axis_name="points"
            )
            s_lb = _trimmed_sum_bisect_psum(
                lb_c + inf_pad, h, upper=False, axis_name="points"
            )
        else:
            s_ub = jax.lax.psum(jnp.sum(ub_c, axis=-1), "points")
            s_lb = jax.lax.psum(jnp.sum(lb_c, axis=-1), "points")
        return jnp.where(mask, s_ub, _INF), jnp.where(mask, s_lb, _INF)

    jobs = P("cubes")
    tgt_spec = P()
    bounds = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(
            P("points", None),    # src_pad
            P("points"),          # norms_pad
            P(),                  # grid (replicated pytree)
            tgt_spec,             # tgt (tile-padded for "exact")
            P(),                  # slack
            P(),                  # thresh (screen backend; others ignore)
            P("cubes", None, None),
            jobs,                 # max_angle
            P("cubes", None),     # t_c
            jobs,                 # t_span
            jobs,                 # mask
        ),
        out_specs=(jobs, jobs),
        # the trimmed reductions all_gather/psum over 'points' leave the
        # outputs replicated on that axis; the VMA checker cannot infer it
        check_vma=False,
    )

    def round_fn(src_pad, norms_pad, grid, tgt, slack, thresh,
                 R, max_angle, t_c, t_span, mask, src, refine_gate=None):
        from goicp_tpu.icp import (
            exact_correspondence,
            grid_correspondence,
            run_icp,
        )

        if backend == "exact":
            padt = (-tgt.shape[0]) % 256
            tgt_b = (
                jnp.concatenate([tgt, jnp.full((padt, 3), 1e15, tgt.dtype)])
                if padt
                else tgt
            )
        else:
            tgt_b = tgt
        ub, lb = bounds(
            src_pad, norms_pad, grid, tgt_b, slack, thresh,
            R, max_angle, t_c, t_span, mask,
        )
        # global (cross-shard) incumbent candidates: XLA partitions the
        # top_k/gather over the 'cubes' sharding — the incumbent all-reduce
        neg_ub, top = jax.lax.top_k(-ub, refine_k)
        R0 = jnp.take(R, top, axis=0)
        t0 = jnp.take(t_c, top, axis=0)
        corr = (
            exact_correspondence(tgt)
            if icp_backend == "exact"
            else grid_correspondence(grid, tgt)
        )
        # ub < refine_factor·best gate (≙ fgoicp.cpp:75) — same contract as
        # bnb.se3_eval._refine_tail; None = refine every top-k candidate
        active0 = None if refine_gate is None else (-neg_ub < refine_gate)
        res = run_icp(
            src, corr, RigidTransform(R0, t0), icp_params, active0=active0
        )
        return ub, lb, res.transform.R, res.transform.t, res.sse, res.iters

    return jax.jit(round_fn)


def make_engine_mesh(p, backend: str, src, norms, *, h: int,
                     icp_params, icp_backend: str, log=None, tag: str = ""):
    """Shared engine-side mesh setup (single-host SE(3) engine and the
    per-host composition in ``dist.multihost``): derive the (cubes × points)
    extents from ``BnbParams.mesh_cubes/mesh_points``, pad the cloud, build
    the jitted sharded round.

    Always uses ``jax.local_devices()`` — identical to ``jax.devices()`` in
    a single process, and the only correct choice under multi-process
    launches (a per-host solve over another host's non-addressable chips
    would deadlock; each engine instance must stay collective-free across
    processes).

    Returns ``None`` when the mesh is trivial (1×1), else
    ``(round_fn, src_pad_dev, norms_pad_dev, n_c, n_p)``.
    """
    from goicp_tpu.dist.sharding import make_mesh

    n_p = max(1, p.mesh_points)
    n_c = (
        max(1, len(jax.local_devices()) // n_p)
        if p.mesh_cubes == 0
        else max(1, p.mesh_cubes)
    )
    if n_c * n_p <= 1:
        return None
    mesh = make_mesh(n_c, n_p, devices=jax.local_devices())
    quantum = 128 if backend in ("mxu", "screen") else p.point_tile
    src_pad, norms_pad = pad_points(
        np.asarray(src, np.float32), np.asarray(norms, np.float32),
        n_p, quantum,
    )
    round_fn = make_sharded_se3_round(
        mesh,
        h=h,
        n_valid=src.shape[0],
        lookup=p.lookup,
        # cube-only meshes screen per shard; point-sharded meshes fall
        # back inside make_sharded_se3_round (see its docstring)
        backend=backend,
        tile=p.point_tile,
        refine_k=p.refine_top_k,
        icp_params=icp_params,
        icp_backend=icp_backend,
    )
    if log is not None:
        log.info(
            "%sSE(3) rounds on a %dx%d (cubes x points) local device mesh",
            tag, n_c, n_p,
        )
    return round_fn, jnp.asarray(src_pad), jnp.asarray(norms_pad), n_c, n_p
