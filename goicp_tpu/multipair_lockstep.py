"""Lockstep multi-pair Go-ICP: every pair's BnB advances through ONE fused
device dispatch per round (split from ``goicp_tpu.multipair``, which
re-exports this surface — both import paths and the module-attribute
patch point ``multipair._register_pairs_lockstep`` stay stable).

The driver generalizes the reference's 32-stream pool
(``registration.cu:109-120``) to a (pair × node) batch axis: per round,
one vmapped/fused kernel evaluates all pairs' job batches, one batched ICP
refines every pair's top candidates, and the host advances B independent
frontiers in lockstep (prior-seeded multistart, trimmed bounds, job-count
bucketing, depth-pipelining — see ``_register_pairs_lockstep``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from goicp_tpu.bnb import BnbParams, GoIcpResult
# device_inner/se3/rotation are imported HERE, not inside the jitted bound
# body: a module's FIRST import executed inside a jit trace runs its
# import-time code under the trace, and any module-level jnp constant
# becomes a leaked tracer that corrupts later unrelated compilations
from goicp_tpu.bnb.device_inner import _exact_min_d2
from goicp_tpu.bnb.se3 import _trimmed_sum_bisect
from goicp_tpu.core.logging import get_logger
from goicp_tpu.core.metrics import Metrics
from goicp_tpu.core.types import RigidTransform
from goicp_tpu.geo.rotation import rotation_displacement
from goicp_tpu.icp import IcpParams, run_icp

# goicp_tpu.multipair re-exports this module AND owns three helpers this
# module calls (_pair_corr, _pad_pair_normals, icp_pairs).  Those are
# imported at FUNCTION level below: a module-level import either way is a
# circular-import trap (whichever module is imported first blocks the
# other's re-export).  By call time both modules are fully initialized, so
# the inner imports are plain sys.modules lookups — no import-time code
# runs under a jit trace (the leaked-tracer hazard the top imports avoid).

_SQRT3 = float(np.sqrt(3.0))
_PREC = jax.lax.Precision.HIGHEST


def _bounds_one_pair(src, w, norms, tgt, slack, R, ang, t_c, t_s, mask, h,
                     trim: bool):
    """(ub, lb) for ``M`` SE(3) nodes of ONE pair, exact brute-force NN with
    per-point weights (0 = padding).  Per-pair body of the ``vmap`` in
    :func:`_pairs_round`; the bound math matches ``bnb.se3`` (Yang et al.
    eq. 10 ≙ ``kernComputeBounds``, ``registration.cu:27-60``).

    ``trim=True``: sums become trimmed sums over the ``h`` smallest
    per-point terms (``h`` may differ per pair — it is a vmapped scalar);
    valid exactly as in jly's trimmed bounds (``jly_goicp.cpp:293-315``) —
    the optimum's inlier set has ≥ the h smallest per-point lower bounds.
    Padded points carry +inf so they never occupy inlier slots."""
    tile = 256
    nt = tgt.shape[0]
    padt = (-nt) % tile
    if padt:
        tgt = jnp.concatenate([tgt, jnp.full((padt, 3), 1e15, tgt.dtype)])
    tgt_tiles = tgt.reshape(-1, tile, 3)
    tgt_norm_tiles = jnp.sum(tgt_tiles * tgt_tiles, axis=-1)

    pts = (
        jnp.einsum("mij,nj->mni", R, src, precision=_PREC) + t_c[:, None, :]
    )                                                       # [M,N,3]
    d2 = _exact_min_d2(pts, tgt_tiles, tgt_norm_tiles)
    return _deflate_pair(d2, w, norms, slack, ang, t_s, mask, h, trim)


def _deflate_pair(d2, w, norms, slack, ang, t_s, mask, h, trim: bool):
    """Shared per-pair bound epilogue: Yang et al. eq. 10 deflation over
    exact per-point distances ``d2 [M, Np]``, then weighted or trimmed
    sums (padded points carry weight 0 / +inf so they neither contribute
    nor occupy inlier slots)."""
    Np = d2.shape[1]
    wp = jnp.pad(w, (0, Np - w.shape[0]))
    norms_p = jnp.pad(norms, (0, Np - norms.shape[0]))
    d = jnp.sqrt(jnp.maximum(d2, 0.0))
    gamma_r = rotation_displacement(ang, norms_p)           # [M, Np]
    gamma_t = (_SQRT3 * t_s)[:, None]
    u = (d + slack) ** 2
    l = jnp.maximum(
        jnp.maximum(d - slack, 0.0) - gamma_r - gamma_t, 0.0
    ) ** 2
    if trim:
        pad_inf = jnp.where(wp[None, :] > 0, 0.0, jnp.float32(np.inf))
        ub = _trimmed_sum_bisect(u + pad_inf, h, upper=True)
        lb = _trimmed_sum_bisect(l + pad_inf, h, upper=False)
    else:
        ub = jnp.sum(u * wp[None, :], axis=-1)
        lb = jnp.sum(l * wp[None, :], axis=-1)
    inf = jnp.float32(np.inf)
    return jnp.where(mask, ub, inf), jnp.where(mask, lb, inf)


@functools.partial(
    jax.jit, static_argnames=("refine_k", "icp_params", "trim")
)
def _pairs_round(srcs, wts, norms, tgts, tnrm, slack, R, ang, t_c, t_s, mask,
                 h, refine_gate=None, *, refine_k: int, icp_params,
                 trim: bool = False):
    """ONE device dispatch advancing every pair: bound evaluation for all
    ``[P, M]`` jobs + top-k batched ICP refinement per pair (the lockstep
    form of ``bnb.se3.se3_round``).  ``h [P]``: per-pair inlier counts
    (trimmed sums when ``trim``); ``tnrm [P,Nt,3]`` (or None): per-pair
    target normals — the refine tail descends the plane metric when
    ``icp_params.metric == "plane"`` while bounds/incumbents stay
    point-SSE (the run_icp contract).

    ``refine_gate [P]`` (or None = ungated): per-pair ICP trigger — only
    top-k candidates with ``ub < refine_gate[p]`` iterate the refine tail
    (≙ the relaxed trigger ``ub < 2·best_sse``, ``fgoicp.cpp:75``, per
    pair).  Also keeps inactive pairs (all-False mask → inf ubs) from
    burning refine iterations on their padded identity poses.

    The bounds are the vmapped XLA exact path on every device (a pair-axis
    device mesh partitions the vmap without collectives)."""
    from goicp_tpu.multipair import _pair_corr

    ub, lb = jax.vmap(
        functools.partial(_bounds_one_pair, trim=trim),
        in_axes=(0, 0, 0, 0, None, 0, 0, 0, 0, 0, 0),
    )(srcs, wts, norms, tgts, slack, R, ang, t_c, t_s, mask, h)

    if refine_gate is None:
        refine_gate = jnp.full((srcs.shape[0],), jnp.inf, jnp.float32)

    def refine_one(src, w, tgt, ub_p, R_p, t_p, gate_p, nrm=None):
        neg_ub, top = jax.lax.top_k(-ub_p, refine_k)
        R0 = jnp.take(R_p, top, axis=0)
        t0 = jnp.take(t_p, top, axis=0)
        res = run_icp(
            src, _pair_corr(tgt, nrm), RigidTransform(R0, t0), icp_params,
            point_weights=w, active0=(-neg_ub < gate_p),
        )
        return res.transform.R, res.transform.t, res.sse, res.iters

    if tnrm is None:
        R_ref, t_ref, sse_ref, it_ref = jax.vmap(refine_one)(
            srcs, wts, tgts, ub, R, t_c, refine_gate
        )
    else:
        R_ref, t_ref, sse_ref, it_ref = jax.vmap(refine_one)(
            srcs, wts, tgts, ub, R, t_c, refine_gate, tnrm
        )
    return ub, lb, R_ref, t_ref, sse_ref, it_ref


def _register_pairs_lockstep(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]], p: BnbParams, mesh=None,
    tgt_normals=None,
    inits: Optional[Sequence[Optional[RigidTransform]]] = None,
    pad_src_to: Optional[int] = None,
) -> List[GoIcpResult]:
    import time

    from goicp_tpu.bnb.frontier import make_frontier
    from goicp_tpu.bnb.solver import _OCTANTS, _PARAMS
    from goicp_tpu.multipair import _pad_pair_normals, icp_pairs

    t_start = time.perf_counter()
    P = len(pairs)
    N = max(s.shape[0] for s, _ in pairs)
    if pad_src_to is not None:
        # shape bucketing (serving): weight-0 padded rows make one compiled
        # round executable exact for every source size under the bucket
        N = max(N, pad_src_to)
    Nt = max(t.shape[0] for _, t in pairs)
    srcs = np.zeros((P, N, 3), np.float32)
    wts = np.zeros((P, N), np.float32)
    tgts = np.full((P, Nt, 3), 1e15, np.float32)
    for b, (s, t) in enumerate(pairs):
        srcs[b, : s.shape[0]] = s
        wts[b, : s.shape[0]] = 1.0
        tgts[b, : t.shape[0]] = t
    norms = np.linalg.norm(srcs, axis=-1).astype(np.float32)
    # inlierNum per pair = n·(1−trim) (≙ jly_goicp.cpp:199-208); trimmed
    # sums/bounds/refinement all use it, and mse normalizes by it
    trim = p.trim_fraction > 0.0
    h = np.array(
        [
            max(1, int(round(s.shape[0] * (1.0 - p.trim_fraction))))
            for s, _ in pairs
        ],
        np.float64,
    )
    sse_thresh = p.mse_threshold * h

    # batched MULTI-START initial ICP: every (pair × seed) refines in one
    # dispatch (the lockstep form of GoIcpSolver._initial_icp; ≙ the single
    # identity start of fgoicp.cpp:11-18).  One step usually lands each
    # pair in its global basin, which the BnB then certifies.  The metric
    # rides through: plane-metric pairs refine plane end-to-end here and in
    # every in-round refine (certification stays point-SSE — run_icp
    # contract), so serve.register_batch keeps the plane win.
    icp_params = IcpParams(
        max_iter=p.icp_max_iter, rel_tol=p.icp_rel_tol,
        trim_fraction=p.trim_fraction, metric=p.icp_metric,
    )
    # in-round refines are incumbent discovery: capped at refine_max_iter
    # and gated per pair at icp_refine_factor·best (same policy as
    # bnb.rounds — the multistart above and any final polish keep the
    # full-strength icp_params)
    icp_params_round = dataclasses.replace(
        icp_params, max_iter=min(p.icp_max_iter, p.refine_max_iter)
    )
    nrm_pad = None
    if p.icp_metric == "plane":
        from goicp_tpu.geo.normals import estimate_normals

        if tgt_normals is None:
            # estimate once per UNIQUE target object (the serving shape
            # passes one resident array P times — pay one PCA pass)
            uniq: dict[int, np.ndarray] = {}
            per = []
            for _, t in pairs:
                key = id(t)
                if key not in uniq:
                    uniq[key] = np.asarray(
                        estimate_normals(jnp.asarray(t), k=p.normals_k),
                        np.float32,
                    )
                per.append(uniq[key])
            tgt_normals = per
        nrm_pad = _pad_pair_normals(tgt_normals, pairs, Nt)
    from goicp_tpu.geo.rotation import random_rotations

    has_inits = inits is not None and any(T is not None for T in inits)
    K = max(2 if has_inits else 1, min(p.init_multistart, 32))
    seeds = np.concatenate(
        [
            np.eye(3, dtype=np.float32)[None],
            random_rotations(K - 1, np.random.default_rng(12345)),
        ]
    )                                                      # [K,3,3]
    R0 = np.tile(seeds, (P, 1, 1))                         # [P·K,3,3]
    t0 = np.zeros((P * K, 3), np.float32)
    for b, (s, t) in enumerate(pairs):
        mu_s, mu_t = s.mean(0), t.mean(0)
        t0[b * K : (b + 1) * K] = mu_t[None] - np.einsum(
            "bij,j->bi", R0[b * K : (b + 1) * K], mu_s
        )
        t0[b * K] = 0.0       # keep the reference's identity start exact
        if inits is not None and inits[b] is not None:
            # per-pair prior (re-localization seed) pinned in slot 1, the
            # lockstep form of GoIcpSolver._initial_icp's caller seed
            # (≙ fgoicp.cpp:11-18 batched); still globally optimal — the
            # BnB certifies whatever basin any seed lands in
            R0[b * K + 1] = np.asarray(inits[b].R, np.float32)
            t0[b * K + 1] = np.asarray(inits[b].t, np.float32)

    # coarse-to-fine (the lockstep form of GoIcpSolver._initial_icp's
    # init_coarse_n stage): every (pair × seed) first converges on
    # nc-point subset clouds — NN cost divided by up to (N/nc)·(Nt/nc) —
    # then only the best few per pair (plus the pinned identity/prior
    # seeds, with their ORIGINAL exact starts) refine at full resolution.
    nc = p.init_coarse_n
    n_min = min(
        min(s.shape[0] for s, _ in pairs), min(t.shape[0] for _, t in pairs)
    )
    if 0 < nc < n_min // 2 and K > 4:
        crng = np.random.default_rng(424242)
        coarse_pairs, coarse_nrm = [], ([] if nrm_pad is not None else None)
        for b, (s, t) in enumerate(pairs):
            sidx = np.sort(crng.choice(s.shape[0], nc, replace=False))
            tidx = np.sort(crng.choice(t.shape[0], nc, replace=False))
            coarse_pairs.append((s[sidx], t[tidx]))
            if coarse_nrm is not None:
                # index the full-cloud normals at the subset rows (cheaper
                # and more accurate than re-estimating on the thin cloud)
                coarse_nrm.append(nrm_pad[b][tidx])
        rep_c = [coarse_pairs[b] for b in range(P) for _ in range(K)]
        rep_cn = (
            None if coarse_nrm is None
            else [coarse_nrm[b] for b in range(P) for _ in range(K)]
        )
        Tc, sse_c, _ = icp_pairs(
            rep_c, inits=RigidTransform(jnp.asarray(R0), jnp.asarray(t0)),
            params=icp_params, normals=rep_cn,
        )
        # one fused fetch (separate np.asarray pulls each pay a device
        # round trip)
        Rc, tc, sse_c = jax.device_get((Tc.R, Tc.t, sse_c))
        sse_c = np.asarray(sse_c, np.float64).reshape(P, K)
        Rc = Rc.reshape(P, K, 3, 3)
        tc = tc.reshape(P, K, 3)
        keep = min(max(4, p.refine_top_k), K)
        K2 = keep + 2                     # + pinned identity / prior slots
        R0n = np.zeros((P, K2, 3, 3), np.float32)
        t0n = np.zeros((P, K2, 3), np.float32)
        for b in range(P):
            top = np.argsort(sse_c[b])[:keep]
            R0n[b, :keep] = Rc[b, top]
            t0n[b, :keep] = tc[b, top]
            R0n[b, keep] = R0[b * K]      # identity start, exact
            t0n[b, keep] = t0[b * K]
            R0n[b, keep + 1] = R0[b * K + 1]   # prior (or seed 1), exact
            t0n[b, keep + 1] = t0[b * K + 1]
        K = K2
        R0 = R0n.reshape(P * K, 3, 3)
        t0 = t0n.reshape(P * K, 3)

    rep_pairs = [pairs[b] for b in range(P) for _ in range(K)]
    rep_nrm = (
        None if nrm_pad is None
        else [nrm_pad[b] for b in range(P) for _ in range(K)]
    )
    T0, sse0, _ = icp_pairs(
        rep_pairs, inits=RigidTransform(jnp.asarray(R0), jnp.asarray(t0)),
        params=icp_params, normals=rep_nrm, pad_src_to=N,
    )
    T0R, T0t, sse0 = jax.device_get((T0.R, T0.t, sse0))   # one fused fetch
    sse0 = np.asarray(sse0, np.float64).reshape(P, K)
    jbest = np.argmin(sse0, axis=1)
    best_R = T0R.reshape(P, K, 3, 3)[np.arange(P), jbest]
    best_t = T0t.reshape(P, K, 3)[np.arange(P), jbest]
    best_sse = sse0[np.arange(P), jbest].copy()

    rotparam = _PARAMS[p.rotation_param]   # axis-angle (jly) or quat cube
    root_rspan = rotparam.root_span
    mean_norm = np.array(
        [np.linalg.norm(s, axis=1).mean() for s, _ in pairs]
    )

    beta = max(p.split_beta, 1e-6)

    def classify(b, pay):
        # the ONE shared split rule (bnb.split); the lockstep gate forces
        # min_rot_span == min_trans_span == 0, so the floors reduce to the
        # engines' implicit 1e-5 translation resolution and is_leaf=False
        from goicp_tpu.bnb.split import classify_split

        split_rot, _ = classify_split(
            pay, mean_norm[b], rotparam, beta=beta,
            rot_floor=0.0, trans_floor=1e-5,
        )
        return split_rot               # split rotation else trans

    fronts = [make_frontier(8) for _ in range(P)]
    for b in range(P):
        root = np.array(
            [0.0, 0.0, 0.0, root_rspan, *p.trans_center, p.trans_span],
            np.float32,
        )
        fronts[b].push(
            root[None], np.zeros(1, np.float32), np.full(1, np.inf, np.float32)
        )

    pop_k = max(32, min(512, p.se3_pop or 512))
    M_cap = 8 * pop_k
    converged = best_sse <= sse_thresh
    rounds = 0
    nodes = np.zeros(P, np.int64)       # per-pair expanded-node counters
    icp_iters = np.zeros(P, np.int64)
    # exact-backend f32-cancellation allowance (≙ GoIcpSolver._exact_slack):
    # conservative mode deducts it from every lower bound so the lockstep
    # path carries the same rigorous certificate as the serial solvers
    if p.conservative:
        import math as _math

        scale = float(
            max(np.abs(s).max() + np.abs(t).max() for s, t in pairs)
            + p.trans_span * _SQRT3
        )
        slack = _math.sqrt(8.0 * 1.2e-7) * scale
    else:
        slack = 0.0
    if mesh is not None and P % mesh.devices.size != 0:
        from goicp_tpu.core.logging import get_logger

        get_logger().warning(
            "pair count %d does not divide over %d mesh devices; running "
            "the lockstep unsharded", P, mesh.devices.size,
        )
        mesh = None
    if mesh is not None:
        # shard the pair axis over the mesh's (single) named axis: each
        # device group owns P/n_devices pairs end-to-end — the vmapped
        # round has no cross-pair data flow, so XLA partitions it without
        # collectives (the pod-slice serving layout)
        from jax.sharding import NamedSharding, PartitionSpec

        axis = mesh.axis_names[0]
        _shard = NamedSharding(mesh, PartitionSpec(axis))
        place = lambda a: jax.device_put(jnp.asarray(a), _shard)
    else:
        place = jnp.asarray
    srcs_d, wts_d, norms_d, tgts_d = map(place, (srcs, wts, norms, tgts))
    tnrm_d = None if nrm_pad is None else place(nrm_pad)
    h_d = place(h.astype(np.float32))
    slack_d = jnp.float32(slack)

    def dispatch():
        """Pop + expand every live pair's best nodes and LAUNCH one fused
        round (async — results fetched by :func:`absorb`)."""
        active = [b for b in range(P) if not converged[b] and len(fronts[b])]
        if not active:
            return None
        childs: dict[int, np.ndarray] = {}
        for b in active:
            pay, _, _ = fronts[b].pop_best(pop_k)
            B = pay.shape[0]
            split_rot = classify(b, pay)
            child = np.repeat(pay, 8, axis=0)
            oct8 = np.tile(_OCTANTS, (B, 1))
            sr = np.repeat(split_rot, 8)
            half_r = np.repeat(pay[:, 3], 8) / 2.0
            half_t = np.repeat(pay[:, 7], 8) / 2.0
            child[sr, 0:3] += oct8[sr] * half_r[sr, None]
            child[sr, 3] = half_r[sr]
            child[~sr, 4:7] += oct8[~sr] * half_t[~sr, None]
            child[~sr, 7] = half_t[~sr]
            keep = rotparam.valid(child[:, 0:3], child[:, 3])
            child = child[keep]
            nodes[b] += child.shape[0]
            childs[b] = child

        # job-count bucketing (same trick as bnb/se3.py): ramp-up/drain
        # rounds with few live children per pair dispatch at the nearest
        # power-of-two bucket instead of the full M_cap padding
        Cmax = max(childs[b].shape[0] for b in active)
        Mb = 512
        while Mb < min(Cmax, M_cap):
            Mb *= 2
        Mb = min(Mb, M_cap)
        R_all = np.tile(np.eye(3, dtype=np.float32), (P, Mb, 1, 1))
        ang_all = np.zeros((P, Mb), np.float32)
        t_all = np.zeros((P, Mb, 3), np.float32)
        ts_all = np.zeros((P, Mb), np.float32)
        mask_all = np.zeros((P, Mb), bool)
        for b in active:
            child = childs[b]
            C = child.shape[0]
            R_all[b, :C] = rotparam.rotation(child[:, 0:3])
            ang_all[b, :C] = rotparam.max_angle(child[:, 0:3], child[:, 3])
            t_all[b, :C] = child[:, 4:7]
            ts_all[b, :C] = child[:, 7]
            mask_all[b, :C] = True
        out = _pairs_round(
            srcs_d, wts_d, norms_d, tgts_d, tnrm_d, slack_d,
            place(R_all), place(ang_all), place(t_all), place(ts_all),
            place(mask_all), h_d,
            place((p.icp_refine_factor * best_sse).astype(np.float32)),
            refine_k=p.refine_top_k, icp_params=icp_params_round, trim=trim,
        )
        return {"childs": childs, "R_all": R_all, "active": active,
                "out": out}

    def absorb(work):
        """Fetch one in-flight round; update incumbents, prune, push.
        Threshold convergence fires here; the gap rule only tests in a
        SETTLED state (no rounds in flight) — with rounds outstanding the
        frontiers are partially drained and min_lb would read spuriously
        high (the same rule as bnb/se3.py's pipelined loop)."""
        ub, lb, R_ref, t_ref, sse_ref, it_ref = map(
            np.asarray, jax.device_get(work["out"])
        )
        R_all = work["R_all"]
        for b in work["active"]:
            child = work["childs"][b]
            C = child.shape[0]
            icp_iters[b] += int(it_ref[b].sum())
            j = int(np.argmin(sse_ref[b]))
            if float(sse_ref[b, j]) < best_sse[b]:
                best_sse[b] = float(sse_ref[b, j])
                best_R[b], best_t[b] = R_ref[b, j], t_ref[b, j]
                fronts[b].prune(best_sse[b] - sse_thresh[b])
            jj = int(np.argmin(ub[b, :C]))
            if float(ub[b, jj]) < best_sse[b]:
                best_sse[b] = float(ub[b, jj])
                best_R[b] = R_all[b, jj]
                best_t[b] = child[jj, 4:7]
                fronts[b].prune(best_sse[b] - sse_thresh[b])
            alive = lb[b, :C] < best_sse[b] - sse_thresh[b]
            if alive.any():
                fronts[b].push(
                    child[alive], lb[b, :C][alive], ub[b, :C][alive]
                )
            if best_sse[b] <= sse_thresh[b]:
                converged[b] = True

    def settled_gap_check():
        for b in range(P):
            if not converged[b] and len(fronts[b]):
                if best_sse[b] - fronts[b].min_lb() <= sse_thresh[b]:
                    converged[b] = True

    # up to pipeline_depth rounds in flight (the lockstep form of the
    # SE(3) engine's pipelining): round k+d pops disjoint frontier slices
    # before round k's results land, hiding host assembly + dispatch
    # latency behind device compute.  Staleness only weakens
    # incumbent-driven pruning by a few rounds — every node is still
    # evaluated, so certificates are unaffected.
    from collections import deque

    inflight: deque = deque()
    depth = max(1, p.pipeline_depth)
    while True:
        if time.perf_counter() - t_start > p.max_wall_s:
            while inflight:
                absorb(inflight.popleft())
            break
        can = rounds < p.max_rounds
        if can and not inflight:
            settled_gap_check()
        if can and len(inflight) < depth:
            work = dispatch()
            if work is not None:
                rounds += 1
                inflight.append(work)
                continue
        if inflight:
            absorb(inflight.popleft())
            continue
        break
    settled_gap_check()

    wall = time.perf_counter() - t_start
    results = []
    for b in range(P):
        done = bool(converged[b]) or not len(fronts[b])
        gap = best_sse[b] - (fronts[b].min_lb() if len(fronts[b]) else best_sse[b])
        results.append(
            GoIcpResult(
                transform=RigidTransform(best_R[b], best_t[b]),
                sse=float(best_sse[b]),
                mse=float(best_sse[b] / h[b]),
                converged=done,
                gap=float(max(gap, 0.0)),
                rot_nodes=int(nodes[b]),
                trans_nodes=int(nodes[b]),
                icp_iters=int(icp_iters[b]),
                rounds=rounds,
                wall_s=wall,
                metrics=Metrics(),
            )
        )
    return results


