"""Device-resident inner BnB: the whole translation search as ONE jitted call.

This is the decisive batched restructuring of the reference's
``branch_and_bound_R3`` (``src/fgoicp/fgoicp.cpp:107-181``).  The reference
pops one TransNode per stream iteration and pays a kernel launch + host sync
per node; a first host-driven port here still paid one dispatch per frontier
*level*, one host round trip each.  This version runs the complete
search for a *batch* of rotation cubes inside a single ``lax.while_loop``:

- frontier: fixed-capacity array ``[G, C]`` of translation cubes per rotation
  cube (≙ the per-query ``std::priority_queue``, ``fgoicp.cpp:117``);
- both bound modes at once: the reference calls the inner BnB twice per cube
  — ``fix_rot=true`` for the upper bound, then ``false`` for the lower bound
  (``fgoicp.cpp:72,93``), re-fetching every distance; here one lookup feeds
  all four objectives (ub/lb × with/without rotation uncertainty);
- ε-pruning exactly like jly (``jly_goicp.cpp:318-321``): a node dies when it
  cannot improve the relevant incumbent (or the global cap) by more than
  ``sse_thresh``; capacity-dropped or depth-limited nodes fold their lower
  bounds into an ``unresolved`` term so the returned bound keeps the same
  ε-optimality guarantee as the references;
- point-tiled reductions: distances stream through ``[G, C, tile]`` blocks
  with running sum + running ``top_k`` for trimmed objectives
  (≙ ``intro_select``, ``jly_sorting.hpp:229``).

Returned per rotation cube: ``inc_ub`` (min evaluated plain SSE — the cube's
upper bound ≙ ``optErrorT``), ``inc_lb`` (min evaluated rotation-deflated SSE
— the cube's jly-style lower bound), ``best_t``, and the unresolved minima.
"""

from __future__ import annotations

import functools
import math

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
# numpy, not jnp: a module-level jnp constant created while this module
# is first imported INSIDE a jit trace (function-level imports in
# multipair._bounds_one_pair) would be a leaked tracer that corrupts
# later compilations (measured: 'Execution supplied 9 buffers but
# compiled program expected 12')
_INF = np.float32(np.inf)

# {-1,+1}^3 octant offsets (≙ fgoicp.cpp:160-173 child spawning)
_OCT = (
    np.array([[(j >> a) & 1 for a in range(3)] for j in range(8)], np.float32)
    * 2.0
    - 1.0
)


def _gather_d2(grid: DistanceGrid, pts, lookup: str):
    """Squared-distance fetch + escape distance (thin wrapper over the
    canonical lookups in ``nn.grid`` — one implementation, two callers)."""
    if lookup == "nearest":
        return lookup_sq_nearest(grid, pts)
    return lookup_sq_trilinear(grid, pts)


def _merge_top(top, vals, drop: int):
    """Running top-``drop``: merge ``top [..., drop]`` with ``vals [..., t]``."""
    cat = jnp.concatenate([top, vals], axis=-1)
    return jax.lax.top_k(cat, drop)[0]


def _exact_min_d2(pts, tgt_tiles, tgt_norm_tiles):
    """Exact min squared distance: ``pts [..., 3]`` vs target tiles
    ``[Tt, tile_t, 3]`` (+1e30-padded), with ``|t|²`` tiles precomputed.

    Mirrors the reference's own finding
    (``README.md:103-106``: brute force beats trees on GPU): for small and
    mid-size targets, streaming dense distance tiles beats random gathers
    into a distance grid — and the bounds become *exact* (no discretization
    slack), which prunes harder.  The inner product is a matmul via the
    ``|p|² − 2p·t + |t|²`` expansion; per-scan-step intermediates are
    ``[X, tile_t]`` only (a naive broadcast difference materializes the full
    pts×targets×3 tensor and OOMs at BnB batch sizes).
    """
    shape = pts.shape[:-1]
    flat = pts.reshape(-1, 3)                              # [X,3]
    pn = jnp.sum(flat * flat, axis=-1)                     # [X]

    def body(best, xs):
        t_tile, tn = xs                                    # [tile_t,3], [tile_t]
        dots = jnp.dot(flat, t_tile.T, precision=_PREC)    # [X, tile_t]
        d2 = tn[None, :] - 2.0 * dots                      # |t|² − 2p·t
        return jnp.minimum(best, jnp.min(d2, axis=-1)), None

    init = jnp.full((flat.shape[0],), _INF, pts.dtype)
    best, _ = jax.lax.scan(body, init, (tgt_tiles, tgt_norm_tiles))
    return jnp.maximum(best + pn, 0.0).reshape(shape)


@functools.partial(
    jax.jit,
    static_argnames=("levels", "C", "h", "lookup", "tile", "backend", "tgt_tile"),
)
def inner_bnb_device(
    src,            # [N,3]
    norms,          # [N]
    grid: DistanceGrid,
    tgt,            # [Nt,3] targets (exact backend; dummy [1,3] for grid)
    slack,          # f32 scalar
    R_g,            # [G,3,3] rotation-cube center rotations
    angle_g,        # [G] rotation-cube max angles
    cap_ub,         # [G] external prune cap for the ub search
    cap_lb,         # [G] external prune cap for the lb search
    t_root_center,  # [3]
    t_root_span,    # f32 scalar
    sse_thresh,     # f32 scalar (≙ SSEThresh, jly_goicp.cpp:199-208)
    min_span,       # f32 scalar subdivision floor (0 = ε-rule only)
    *,
    levels: int = 12,
    C: int = 64,
    h: int = 0,     # trimmed inlier count; 0 or N ⇒ untrimmed
    lookup: str = "trilinear",
    tile: int = 128,
    backend: str = "grid",   # "grid" (LUT ≙ tex3D) | "exact" (≙ brute force)
    tgt_tile: int = 256,
):
    G, N = R_g.shape[0], src.shape[0]
    K = C // 8
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

    pts0 = jnp.einsum("gij,nj->gni", R_g, src, precision=_PREC)  # [G,N,3]
    gamma_r = rotation_displacement(angle_g, norms)               # [G,N]

    n_tiles = -(-N // tile)
    pad = n_tiles * tile - N
    if pad:
        pts0 = jnp.pad(pts0, ((0, 0), (0, pad), (0, 0)))
        gamma_r = jnp.pad(gamma_r, ((0, 0), (0, pad)))
    pt_mask = (jnp.arange(n_tiles * tile) < N).astype(jnp.float32)
    pts0_t = pts0.reshape(G, n_tiles, tile, 3).swapaxes(0, 1)     # [T,G,tile,3]
    gr_t = gamma_r.reshape(G, n_tiles, tile).swapaxes(0, 1)       # [T,G,tile]
    pm_t = pt_mask.reshape(n_tiles, tile)                          # [T,tile]

    def eval_nodes(centers, spans, valid):
        """Evaluate all [G,C] nodes; returns the four objectives [G,C]."""
        gt = (_SQRT3 * spans)[..., None]  # [G,C,1]

        def tile_body(carry, xs):
            sums, tops = carry
            p_t, g_t, m_t = xs  # [G,tile,3], [G,tile], [tile]
            pts = p_t[:, None, :, :] + centers[:, :, None, :]  # [G,C,tile,3]
            if backend == "exact":
                d = jnp.sqrt(_exact_min_d2(pts, tgt_tiles, tgt_norm_tiles))
                d_lo = jnp.maximum(d - slack, 0.0)
                d_hi = d + slack
            else:
                val, esc = _gather_d2(grid, pts, lookup)
                d = jnp.sqrt(jnp.maximum(val, 0.0))
                d_lo = jnp.maximum(d - esc - slack, 0.0)
                d_hi = d + esc + slack
            gr = g_t[:, None, :]
            c_fix = (d_hi**2) * m_t
            l_fix = jnp.maximum(d_lo - gt, 0.0) ** 2 * m_t
            c_rot = jnp.maximum(d_lo - gr, 0.0) ** 2 * m_t
            l_rot = jnp.maximum(d_lo - gr - gt, 0.0) ** 2 * m_t
            objs = (c_fix, l_fix, c_rot, l_rot)
            sums = tuple(s + jnp.sum(o, axis=-1) for s, o in zip(sums, objs))
            if drop:
                tops = tuple(
                    _merge_top(t, o, drop) for t, o in zip(tops, objs)
                )
            return (sums, tops), None

        zero = jnp.zeros((G, C), jnp.float32)
        if drop:
            tops0 = tuple(jnp.full((G, C, drop), -_INF) for _ in range(4))
        else:
            tops0 = tuple(zero[..., None] for _ in range(4))  # placeholder
        (sums, tops), _ = jax.lax.scan(
            tile_body, ((zero,) * 4, tops0), (pts0_t, gr_t, pm_t)
        )
        if drop:
            sums = tuple(
                s - jnp.sum(jnp.maximum(t, 0.0), axis=-1)
                for s, t in zip(sums, tops)
            )
        return tuple(jnp.where(valid, s, _INF) for s in sums)

    def init_state():
        centers = jnp.zeros((G, C, 3), jnp.float32).at[:, 0, :].set(t_root_center)
        spans = jnp.zeros((G, C), jnp.float32).at[:, 0].set(t_root_span)
        valid = jnp.zeros((G, C), bool).at[:, 0].set(True)
        return (
            centers, spans, valid,
            jnp.full((G,), _INF),  # inc_ub
            jnp.full((G,), _INF),  # inc_lb
            jnp.broadcast_to(t_root_center, (G, 3)).astype(jnp.float32),
            jnp.full((G,), _INF),  # unres_ub
            jnp.full((G,), _INF),  # unres_lb
            jnp.int32(0),          # level
            jnp.int32(0),          # nodes evaluated
        )

    def absorb(state):
        """One BnB level: evaluate, update incumbents, prune, subdivide."""
        (centers, spans, valid, inc_ub, inc_lb, best_t,
         unres_ub, unres_lb, level, nodes) = state
        cv_fix, lb_fix, cv_rot, lb_rot = eval_nodes(centers, spans, valid)
        nodes = nodes + jnp.sum(valid.astype(jnp.int32))

        # incumbent updates (≙ fgoicp.cpp:144-150)
        i = jnp.argmin(cv_fix, axis=1)
        cand_ub = jnp.take_along_axis(cv_fix, i[:, None], 1)[:, 0]
        better = cand_ub < inc_ub
        best_t = jnp.where(
            better[:, None],
            jnp.take_along_axis(centers, i[:, None, None], 1)[:, 0, :],
            best_t,
        )
        inc_ub = jnp.minimum(inc_ub, cand_ub)
        inc_lb = jnp.minimum(inc_lb, jnp.min(cv_rot, axis=1))

        # ε-prune against incumbents and external caps (jly_goicp.cpp:318-321)
        lim_ub = (jnp.minimum(inc_ub, cap_ub) - sse_thresh)[:, None]
        lim_lb = (jnp.minimum(inc_lb, cap_lb) - sse_thresh)[:, None]
        alive = valid & ((lb_fix < lim_ub) | (lb_rot < lim_lb))

        # depth floor (≙ fgoicp.cpp:160): stuck nodes become unresolved
        can_div = spans / 2.0 >= min_span
        stuck = alive & ~can_div
        unres_ub = jnp.minimum(
            unres_ub, jnp.min(jnp.where(stuck, lb_fix, _INF), axis=1)
        )
        unres_lb = jnp.minimum(
            unres_lb, jnp.min(jnp.where(stuck, lb_rot, _INF), axis=1)
        )

        # select the K best expandables; capacity-dropped → unresolved
        expand = alive & can_div
        prio = jnp.where(expand, jnp.minimum(lb_fix, lb_rot), _INF)
        _, sel = jax.lax.top_k(-prio, K)                      # [G,K]
        sel_ok = jnp.take_along_axis(prio, sel, 1) < _INF
        sel_mask = jnp.zeros((G, C), bool)
        sel_mask = sel_mask.at[jnp.arange(G)[:, None], sel].set(sel_ok)
        dropped = expand & ~sel_mask
        unres_ub = jnp.minimum(
            unres_ub, jnp.min(jnp.where(dropped, lb_fix, _INF), axis=1)
        )
        unres_lb = jnp.minimum(
            unres_lb, jnp.min(jnp.where(dropped, lb_rot, _INF), axis=1)
        )

        # 8-way children fill the frontier exactly
        c_sel = jnp.take_along_axis(centers, sel[..., None], 1)  # [G,K,3]
        s_sel = jnp.take_along_axis(spans, sel, 1)               # [G,K]
        half = (s_sel / 2.0)[..., None]
        child_c = (
            c_sel[:, :, None, :] + _OCT[None, None] * half[..., None]
        ).reshape(G, C, 3)
        child_s = jnp.repeat(s_sel / 2.0, 8, axis=1)
        child_v = jnp.repeat(sel_ok, 8, axis=1)
        return (
            child_c, child_s, child_v, inc_ub, inc_lb, best_t,
            unres_ub, unres_lb, level + 1, nodes,
        )

    def cond(state):
        valid, level = state[2], state[8]
        return jnp.logical_and(jnp.any(valid), level < levels)

    state = jax.lax.while_loop(cond, absorb, init_state())
    # children spawned on the last level were never evaluated: fold their
    # (parent-monotone) information in as unresolved via one more evaluation
    (centers, spans, valid, inc_ub, inc_lb, best_t,
     unres_ub, unres_lb, _, nodes) = state

    def final_eval(args):
        inc_ub, inc_lb, best_t, unres_ub, unres_lb, nodes = args
        cv_fix, lb_fix, cv_rot, lb_rot = eval_nodes(centers, spans, valid)
        nodes = nodes + jnp.sum(valid.astype(jnp.int32))
        i = jnp.argmin(cv_fix, axis=1)
        cand_ub = jnp.take_along_axis(cv_fix, i[:, None], 1)[:, 0]
        better = cand_ub < inc_ub
        best_t = jnp.where(
            better[:, None],
            jnp.take_along_axis(centers, i[:, None, None], 1)[:, 0, :],
            best_t,
        )
        inc_ub = jnp.minimum(inc_ub, cand_ub)
        inc_lb = jnp.minimum(inc_lb, jnp.min(cv_rot, axis=1))
        unres_ub = jnp.minimum(
            unres_ub, jnp.min(jnp.where(valid, lb_fix, _INF), axis=1)
        )
        unres_lb = jnp.minimum(
            unres_lb, jnp.min(jnp.where(valid, lb_rot, _INF), axis=1)
        )
        return inc_ub, inc_lb, best_t, unres_ub, unres_lb, nodes

    out = jax.lax.cond(
        jnp.any(valid),
        final_eval,
        lambda a: a,
        (inc_ub, inc_lb, best_t, unres_ub, unres_lb, nodes),
    )
    inc_ub, inc_lb, best_t, unres_ub, unres_lb, nodes = out
    return inc_ub, inc_lb, best_t, unres_ub, unres_lb, nodes
