"""SE(3) bound-evaluation and fused-round dispatch layer (split from
``bnb.se3``, which re-exports everything here — both import paths stable).

The jitted building blocks of one BnB round: exact/fused/screened bound
evaluators (singleton, 8-sibling grouped, trimmed), the shared batched-ICP
refine tail, and the two fused round entry points ``se3_round`` /
``se3_round_grouped`` consumed by the shared round driver
(``bnb.rounds.Se3RoundDriver``).  See the ``bnb.se3`` module docstring for
the engine design rationale and reference mapping.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.bnb.device_inner import _exact_min_d2, _gather_d2
from goicp_tpu.core.types import RigidTransform
from goicp_tpu.geo.rotation import rotation_displacement

_SQRT3 = math.sqrt(3.0)
_PREC = jax.lax.Precision.HIGHEST
_INF = np.float32(np.inf)  # numpy on purpose — see device_inner._INF


def _trimmed_sum_bisect(x, h: int, upper: bool, iters: int = 24):
    """Sum of the ``h`` smallest entries per row of ``x [M, Np]`` by
    bisection on a value threshold τ: after ``iters`` halvings,

        S(τ_lo) + (h − C(τ_lo))·τ_lo  ≤  trimmed_h  ≤  S(τ_lo) + (h − C(τ_lo))·τ_hi

    where ``S/C`` are the masked sum/count at the threshold.  ``upper``
    selects which side to return, so upper-bound objectives stay upper
    bounds and lower-bound objectives stay lower bounds.  Cost: ``iters``
    cheap masked reductions — no sort, no top_k.
    """
    rowmax = jnp.max(jnp.where(x < 1e29, x, 0.0), axis=-1)  # ignore pad inf
    lo = jnp.zeros_like(rowmax)
    hi = rowmax + 1e-12

    def body(carry, _):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum((x <= mid[:, None]).astype(jnp.float32), axis=-1)
        take = cnt >= h
        return (jnp.where(take, lo, mid), jnp.where(take, mid, hi)), None

    (lo, hi), _ = jax.lax.scan(body, (lo, hi), None, length=iters)
    sel = x <= lo[:, None]
    S = jnp.sum(jnp.where(sel, x, 0.0), axis=-1)
    C = jnp.sum(sel.astype(jnp.float32), axis=-1)
    rem = jnp.maximum(h - C, 0.0)
    return S + rem * (hi if upper else lo)


def _deflate_and_reduce(d2, norms, slack, max_angle, t_span, mask, *,
                        h: int, N: int):
    """Shared bound epilogue over per-node exact distances ``d2 [M, Np]``:
    Yang et al. eq. 10 deflation by the per-point rotation radius and the
    translation corner radius, then (trimmed) sums (≙ the thrust reduces at
    ``registration.cu:123-142``)."""
    M, Np = d2.shape
    drop = 0 if h in (0, N) else N - h
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    d_lo = jnp.maximum(d - slack, 0.0)
    d_hi = d + slack
    gamma_r = rotation_displacement(max_angle, norms)  # [M, N]
    if Np > N:
        gamma_r = jnp.pad(gamma_r, ((0, 0), (0, Np - N)))
    gamma_t = (_SQRT3 * t_span)[:, None]
    pmask = (jnp.arange(Np) < N).astype(jnp.float32)[None, :]
    ub_c = (d_hi**2) * pmask
    lb_c = jnp.maximum(d_lo - gamma_r - gamma_t, 0.0) ** 2 * pmask
    if drop:
        inf_pad = (1.0 - pmask) * 1e30
        s_ub = _trimmed_sum_bisect(ub_c + inf_pad, h, upper=True)
        s_lb = _trimmed_sum_bisect(lb_c + inf_pad, h, upper=False)
    else:
        s_ub = jnp.sum(ub_c, axis=-1)
        s_lb = jnp.sum(lb_c, axis=-1)
    return jnp.where(mask, s_ub, _INF), jnp.where(mask, s_lb, _INF)


@functools.partial(jax.jit, static_argnames=("h",))
def evaluate_se3_nodes_mxu(
    src, norms, tgt, slack, R, max_angle, t_c, t_span, mask, *, h: int,
):
    """Unfused exact bound evaluation: one Pallas dispatch computes the
    per-point NN distances of every node (``nn.mxu.min_d2_nodes`` — exact
    f32 differences, no ``|q|² − 2q·m + |m|²`` cancellation); the deflation
    + (trimmed) reductions are an XLA epilogue over ``[M, Np]``.

    ≙ ``kernComputeBounds`` + reduce (``registration.cu:27-60,88-151``) with
    the LUT texture replaced by exact brute force (no discretization slack).
    """
    from goicp_tpu.nn import mxu as _mxu

    d2 = _mxu.min_d2_nodes(src, tgt, R, t_c)           # [M, Np]
    return _deflate_and_reduce(
        d2, norms, slack, max_angle, t_span, mask, h=h, N=src.shape[0]
    )


@functools.partial(jax.jit, static_argnames=("h",))
def evaluate_se3_groups_mxu(
    src, norms, tgt, slack, R, max_angle, t8, t_span8, mask, *, h: int,
):
    """Grouped bound evaluation for 8 translation siblings per rotation
    (an octant t-split): ``R [G,3,3]``, ``max_angle [G]``, ``t8 [G,8,3]``,
    ``t_span8 [G,8]``, ``mask [G·8]`` → ``(ub, lb) [G·8]`` in group-major
    node order.  The grouped kernel (``nn.mxu.min_d2_groups``) amortizes the
    base distance plane over the 8 siblings."""
    from goicp_tpu.nn import mxu as _mxu

    d2 = _mxu.min_d2_groups(src, tgt, _mxu.pack_group_params(R, t8))
    return _deflate_and_reduce(
        d2,
        norms,
        slack,
        jnp.repeat(max_angle, 8),
        t_span8.reshape(-1),
        mask,
        h=h,
        N=src.shape[0],
    )


@functools.partial(
    jax.jit,
    static_argnames=("h", "lookup", "backend", "tile", "tgt_tile"),
)
def evaluate_se3_nodes(
    src,        # [N,3]
    norms,      # [N]
    grid,
    tgt,        # [Nt,3] (exact backend; [1,3] dummy for grid)
    slack,      # f32 scalar
    R,          # [M,3,3]
    max_angle,  # [M]
    t_c,        # [M,3]
    t_span,     # [M]
    mask,       # [M] bool
    *,
    h: int = 0,
    lookup: str = "trilinear",
    backend: str = "exact",
    tile: int = 128,
    tgt_tile: int = 256,
):
    """One dispatch: (ub, lb) for a flat batch of SE(3) nodes.

    ≙ ``kernComputeBounds`` + reduce (``registration.cu:27-60,88-151``) but
    for thousands of 6-D nodes at once instead of one per stream.
    """
    M, N = R.shape[0], src.shape[0]
    drop = 0 if h in (0, N) else N - h

    if backend == "exact":
        nt = tgt.shape[0]
        padt = (-nt) % tgt_tile
        if padt:
            tgt = jnp.concatenate(
                [tgt, jnp.full((padt, 3), 1e15, tgt.dtype)], axis=0
            )
        tgt_tiles = tgt.reshape(-1, tgt_tile, 3)
        tgt_norm_tiles = jnp.sum(tgt_tiles * tgt_tiles, axis=-1)

    gamma_r = rotation_displacement(max_angle, norms)   # [M,N]
    gamma_t = (_SQRT3 * t_span)[:, None]                # [M,1]

    n_tiles = -(-N // tile)
    pad = n_tiles * tile - N
    src_p = jnp.pad(src, ((0, pad), (0, 0))) if pad else src
    gr_p = jnp.pad(gamma_r, ((0, 0), (0, pad))) if pad else gamma_r
    pt_mask = (jnp.arange(n_tiles * tile) < N).astype(jnp.float32)
    src_t = src_p.reshape(n_tiles, tile, 3)
    gr_t = gr_p.reshape(M, n_tiles, tile).swapaxes(0, 1)   # [T,M,tile]
    pm_t = pt_mask.reshape(n_tiles, tile)

    def tile_body(carry, xs):
        s_ub, s_lb = carry
        s_tile, g_tile, m_tile = xs                        # [tile,3],[M,tile],[tile]
        pts = (
            jnp.einsum("mij,tj->mti", R, s_tile, precision=_PREC)
            + t_c[:, None, :]
        )                                                   # [M,tile,3]
        if backend == "exact":
            d = jnp.sqrt(_exact_min_d2(pts, tgt_tiles, tgt_norm_tiles))
            # slack here is the f32-cancellation allowance of the matmul
            # expansion (certified mode; 0 in reference-parity mode)
            d_lo = jnp.maximum(d - slack, 0.0)
            d_hi = d + slack
        else:
            val, esc = _gather_d2(grid, pts, lookup)
            d = jnp.sqrt(jnp.maximum(val, 0.0))
            d_lo = jnp.maximum(d - esc - slack, 0.0)
            d_hi = d + esc + slack
        ub_c = (d_hi**2) * m_tile
        lb_c = jnp.maximum(d_lo - g_tile - gamma_t, 0.0) ** 2 * m_tile
        s_ub = s_ub + jnp.sum(ub_c, axis=-1)
        s_lb = s_lb + jnp.sum(lb_c, axis=-1)
        if drop:
            # padding must never occupy inlier slots of the trimmed sums
            inf_pad = (1.0 - m_tile) * 1e30
            return (s_ub, s_lb), (ub_c + inf_pad, lb_c + inf_pad)
        return (s_ub, s_lb), None

    zero = jnp.zeros((M,), jnp.float32)
    (s_ub, s_lb), stored = jax.lax.scan(
        tile_body, (zero, zero), (src_t, gr_t, pm_t)
    )
    if drop:
        # Exact trimmed sums by threshold bisection over the STORED
        # contributions (≙ intro_select, jly_sorting.hpp:229 — but O(N) per
        # pass and fully vectorized; the top_k-merge alternative is
        # O(N·drop) per node and melts at large trim counts).
        c_ub = stored[0].swapaxes(0, 1).reshape(M, -1)      # [M, Np]
        c_lb = stored[1].swapaxes(0, 1).reshape(M, -1)
        s_ub = _trimmed_sum_bisect(c_ub, h, upper=True)
        s_lb = _trimmed_sum_bisect(c_lb, h, upper=False)
    return jnp.where(mask, s_ub, _INF), jnp.where(mask, s_lb, _INF)


@functools.partial(jax.jit, static_argnames=("h",))
def evaluate_se3_nodes_screened(
    src, norms, tgt, slack, thresh, R, max_angle, t_c, t_span, mask, *, h: int,
):
    """Fused-epilogue bound evaluation with PROGRESSIVE SCREENING
    (``nn.mxu.bounds_nodes``): partial lower-bound sums prune most nodes
    after a fraction of the cloud (see the kernel docs).  Untrimmed only:
    a partial sum of the smallest-h terms is not a lower bound, so trimmed
    solves take the unfused path (``bnb.solver`` routes them there)."""
    from goicp_tpu.nn import mxu as _mxu

    if h not in (0, src.shape[0]):
        raise ValueError("the screened bound kernel is untrimmed-only")
    af = 2.0 * jnp.sin(jnp.minimum(max_angle, jnp.pi) / 2.0)
    params = _mxu.pack_params_bounds(
        R, t_c, af, _SQRT3 * t_span, slack, thresh
    )
    ub, lb = _mxu.bounds_nodes(src, norms, tgt, params)
    return jnp.where(mask, ub, _INF), jnp.where(mask, lb, _INF)


@functools.partial(
    jax.jit,
    static_argnames=(
        "h", "lookup", "backend", "tile", "tgt_tile", "refine_k", "icp_params",
        "icp_backend",
    ),
)
def se3_round(
    src, norms, grid, tgt, tgt_normals, slack, thresh,
    R, max_angle, t_c, t_span, mask,
    *,
    h: int,
    lookup: str,
    backend: str,
    tile: int,
    tgt_tile: int,
    refine_k: int,
    icp_params,
    icp_backend: str,
    refine_gate=None,
):
    """One FUSED BnB round: bound evaluation + top-k batched ICP refinement
    in a single dispatch (one host↔device round trip per outer round —
    the reference pays a launch+sync per *node*, ``registration.cu:144``).

    ``thresh`` = incumbent − ε at dispatch time: the screened kernel prunes
    nodes from partial lower-bound sums (backend "screen"); other backends
    ignore it.  ``tgt_normals [Nt,3]`` (or None) feed the refine tail when
    ``icp_params.metric == "plane"`` — bounds stay point-metric either way
    (the ε-certificate is a point-SSE statement).  ``refine_gate`` (traced
    scalar, or None = ungated): only top-k candidates with ``ub <
    refine_gate`` actually iterate ICP — the reference's relaxed trigger
    ``ub < 2·best_sse`` (``fgoicp.cpp:75``), which the flat engine
    previously ignored, paying a full batched refine EVERY round.  Returns
    ``(ub, lb, R_ref, t_ref, sse_ref)`` where the last three are the
    ICP-refined poses of the ``refine_k`` best-ub nodes (gated-off poses
    report ``sse=inf``).

    ``max_angle`` is either the per-node bound angles ``[M]`` or a
    ``(centers [M,3], spans [M])`` tuple — the tuple form computes the
    center-aware tight cube angle bound IN-PROGRAM, so a round stays one
    dispatch (a separate chained program per round would make every round
    wait for the previous one's inputs).
    """
    if isinstance(max_angle, tuple):
        from goicp_tpu.geo.rotation import axis_angle_cube_max_angle

        max_angle = axis_angle_cube_max_angle(*max_angle)
    if backend == "screen":
        ub, lb = evaluate_se3_nodes_screened(
            src, norms, tgt, slack, thresh, R, max_angle, t_c, t_span, mask,
            h=h,
        )
    elif backend == "mxu":
        ub, lb = evaluate_se3_nodes_mxu(
            src, norms, tgt, slack, R, max_angle, t_c, t_span, mask, h=h,
        )
    else:
        ub, lb = evaluate_se3_nodes(
            src, norms, grid, tgt, slack, R, max_angle, t_c, t_span, mask,
            h=h, lookup=lookup, backend=backend, tile=tile, tgt_tile=tgt_tile,
        )
    return _refine_tail(
        ub, lb, R, t_c, src, grid, tgt, tgt_normals, refine_k, icp_params,
        icp_backend, refine_gate,
    )


def _refine_tail(ub, lb, R, t_c, src, grid, tgt, tgt_normals, refine_k,
                 icp_params, icp_backend, refine_gate=None):
    """Shared round tail: batched ICP on the ``refine_k`` best-ub nodes.

    ``tgt_normals`` (or None) make the in-round refinement plane-metric-
    capable (≙ the refiner it upgrades, ``icp3d.cu:140-172``); the reported
    sse stays point-to-point (run_icp contract), so incumbents and the
    ε-certificate are metric-independent.  ``refine_gate``: see
    :func:`se3_round` — candidates at or above the gate (and padded inf-ub
    slots) start inactive, so a round with nothing promising skips the ICP
    while_loop entirely."""
    from goicp_tpu.icp import exact_correspondence, grid_correspondence, run_icp

    neg_ub, top = jax.lax.top_k(-ub, refine_k)
    R0 = jnp.take(R, top, axis=0)
    t0 = jnp.take(t_c, top, axis=0)
    corr = (
        exact_correspondence(tgt, normals=tgt_normals)
        if icp_backend == "exact"
        else grid_correspondence(grid, tgt, normals=tgt_normals)
    )
    active0 = None if refine_gate is None else (-neg_ub < refine_gate)
    res = run_icp(
        src, corr, RigidTransform(R0, t0), icp_params, active0=active0
    )
    return ub, lb, res.transform.R, res.transform.t, res.sse, res.iters


@functools.partial(
    jax.jit,
    static_argnames=(
        "h", "lookup", "backend", "tile", "tgt_tile", "refine_k", "icp_params",
        "icp_backend",
    ),
)
def se3_round_grouped(
    src, norms, grid, tgt, tgt_normals, slack, thresh,
    R, max_angle, t8, t_span8, mask,
    *,
    h: int,
    lookup: str,
    backend: str,
    tile: int,
    tgt_tile: int,
    refine_k: int,
    icp_params,
    icp_backend: str,
    refine_gate=None,
):
    """One fused BnB round over TRANSLATION-SPLIT groups: ``G`` parent
    rotations × 8 translation octant children each (``R [G,3,3]``,
    ``t8 [G,8,3]``).  On the mxu/screen backends the grouped kernel
    amortizes the rotation's distance plane across the 8 siblings; other
    backends flatten to per-node jobs.  Node order is group-major.
    ``refine_gate`` and the ``max_angle`` tuple form: see
    :func:`se3_round` (here the tuple is per-group ``([G,3], [G])``)."""
    if isinstance(max_angle, tuple):
        from goicp_tpu.geo.rotation import axis_angle_cube_max_angle

        max_angle = axis_angle_cube_max_angle(*max_angle)
    G = R.shape[0]
    R_flat = jnp.repeat(R, 8, axis=0)                  # [8G,3,3]
    t_flat = t8.reshape(8 * G, 3)
    if backend in ("mxu", "screen"):
        # T-rounds run the unscreened grouped kernel on both backends: a
        # group-granularity screen (all 8 siblings must cross) fires too
        # rarely to pay for its per-block predicate
        ub, lb = evaluate_se3_groups_mxu(
            src, norms, tgt, slack, R, max_angle, t8, t_span8, mask, h=h,
        )
    else:
        ub, lb = evaluate_se3_nodes(
            src, norms, grid, tgt, slack, R_flat,
            jnp.repeat(max_angle, 8), t_flat, t_span8.reshape(-1), mask,
            h=h, lookup=lookup, backend=backend, tile=tile, tgt_tile=tgt_tile,
        )
    return _refine_tail(
        ub, lb, R_flat, t_flat, src, grid, tgt, tgt_normals, refine_k,
        icp_params, icp_backend, refine_gate,
    )


