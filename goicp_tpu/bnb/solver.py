"""Go-ICP: globally-optimal registration by nested branch-and-bound.

A batched reorganization of both reference solvers — ``FastGoICP``
(``src/fgoicp/fgoicp.cpp:32-181``) and jly ``GoICP::OuterBnB/InnerBnB``
(``src/goicp/jly_goicp.cpp:227-567``).  Structure inversion (SURVEY §7.6):

- **device**: one jitted step evaluates a flat batch of (rotation, trans-cube)
  jobs — hundreds of cubes per step instead of the reference's one node per
  stream (``fgoicp.cpp:127`` pulls batches of size 1);
- **host**: thin frontier loop — select, subdivide, prune.  The outer search
  is best-first over rotation cubes (≙ both references' priority queues); the
  inner translation search is breadth-first with pruning, batched across
  *all* rotation candidates and *both* bound modes at once: the reference
  runs ``branch_and_bound_R3(fix_rot=true)`` then ``(fix_rot=false)``
  sequentially per cube (``fgoicp.cpp:72,93``); here the (cube × mode)
  product is one job stream.
- **ICP refinement** is itself batched: every candidate whose upper bound
  beats ``refine_factor · best_sse`` (≙ the relaxed trigger ``ub < best*2``,
  ``fgoicp.cpp:75``) is refined simultaneously by the batched ICP solver.

Rotation search space: quaternion cube ``[-1,1]^3`` (fgoicp, ``common.h:40-60``)
or axis-angle π-cube (jly, ``jly_goicp.cpp:44-48``), selected by config.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from goicp_tpu.bnb.bounds import BoundsEvaluator
from goicp_tpu.bnb.device_inner import inner_bnb_device
from goicp_tpu.bnb.frontier import make_cube_frontier
from goicp_tpu.core.logging import get_logger
from goicp_tpu.core.metrics import Metrics
from goicp_tpu.core.progress import ProgressBus, SolverState
from goicp_tpu.core.types import RigidTransform
from goicp_tpu.geo import rotation as rot
from goicp_tpu.geo.normals import estimate_normals
from goicp_tpu.icp import IcpParams, grid_correspondence, run_icp
from goicp_tpu.nn.grid import build_distance_grid

_SQRT3 = math.sqrt(3.0)
_OCTANTS = (
    np.array([[(j >> a) & 1 for a in range(3)] for j in range(8)], np.float32) * 2.0
    - 1.0
)  # {-1,+1}^3


from goicp_tpu.bnb.params import (  # noqa: F401  (stable re-exports)
    BnbParams,
    GoIcpResult,
    auto_backend,
)
from goicp_tpu.bnb.rotparam import (  # noqa: F401  (stable re-exports)
    _PARAMS,
    AxisAngleParam,
    QuatParam,
)



@functools.partial(jax.jit, static_argnames=("params",))
def _grid_icp(src, grid, tgt, R, t, params: IcpParams, normals=None):
    """Module-level jitted batched grid-correspondence ICP: one compiled
    executable shared across solver instances with same-shaped problems.
    ``normals``: target normals for ``params.metric="plane"``."""
    corr = grid_correspondence(grid, tgt, normals=normals)
    return run_icp(src, corr, RigidTransform(R, t), params)


@functools.partial(jax.jit, static_argnames=("params",))
def _exact_icp(src, tgt, R, t, params: IcpParams, normals=None):
    """Exact brute-force-NN ICP (≙ ``icp3d.cu:13-30``): used when the target
    cloud is small enough that exact correspondences are cheap — the refined
    SSE is then the *true* objective, which tightens incumbent-driven
    pruning (a grid-correspondence SSE overestimates)."""
    from goicp_tpu.icp import exact_correspondence

    corr = exact_correspondence(tgt, normals=normals)
    return run_icp(src, corr, RigidTransform(R, t), params)



# ---------------------------------------------------------------------------
# outer BnB
# ---------------------------------------------------------------------------


class GoIcpSolver:
    """Globally-optimal registration of ``src`` onto ``tgt``.

    ≙ ``FastGoICP`` (``fgoicp.hpp:12-70``): owns the distance field, the
    bound evaluator, and the batched ICP refiner; ``run()`` is the solve.
    """

    def __init__(
        self,
        src: np.ndarray,
        tgt: np.ndarray,
        params: BnbParams = BnbParams(),
        progress: Optional[ProgressBus] = None,
        grid=None,
        normals=None,
        bound_idx=None,
    ):
        # fail fast on enum knobs: a typo would otherwise route silently
        # (an unknown bound_backend falls through to the grid path, an
        # unknown engine to "nested", a bad icp_metric errors deep inside
        # the first jitted ICP trace) — ADVICE r3 generalized
        if params.icp_metric not in ("point", "plane"):
            raise ValueError(
                f"icp_metric must be 'point' or 'plane', "
                f"got {params.icp_metric!r}"
            )
        if params.engine not in ("se3", "nested"):
            raise ValueError(
                f"engine must be 'se3' or 'nested', got {params.engine!r}"
            )
        if params.bound_backend not in (
            "auto", "mxu", "exact", "grid", "screen"
        ):
            raise ValueError(
                f"bound_backend must be one of auto/mxu/exact/grid/screen, "
                f"got {params.bound_backend!r}"
            )
        if params.lookup not in ("nearest", "trilinear"):
            raise ValueError(
                f"lookup must be 'nearest' or 'trilinear', "
                f"got {params.lookup!r}"
            )
        if params.rotation_param not in _PARAMS:
            raise ValueError(
                f"rotation_param must be one of {sorted(_PARAMS)}, "
                f"got {params.rotation_param!r}"
            )
        self.src_full = np.asarray(src, np.float32)
        self.src = self.src_full
        self.tgt = np.asarray(tgt, np.float32)
        self.p = params
        self.progress = progress or ProgressBus()
        self.metrics = Metrics()
        self.log = get_logger()
        if bound_idx is not None:
            # explicit solve subset (the adaptive full-cloud certification
            # loop, bnb.fullcert — it grows the subset with the
            # worst-covered points between refinements)
            self.src = self.src_full[np.sort(np.asarray(bound_idx))]
            self.log.info(
                "BnB solves on an explicit %d-point subset of %d",
                self.src.shape[0], self.src_full.shape[0],
            )
        elif self.src.shape[0] > params.bound_points:
            # deterministic thinning for the solve; full cloud kept for the
            # final polish (≙ the reference's subsample, but recoverable)
            idx = np.random.default_rng(777).choice(
                self.src.shape[0], params.bound_points, replace=False
            )
            self.src = self.src_full[np.sort(idx)]
            self.log.info(
                "BnB solves on %d of %d source points (bound_points cap)",
                self.src.shape[0],
                self.src_full.shape[0],
            )

        # exact bounds beat the grid for small and mid-size targets (≙ the
        # reference's own brute-force-beats-kd-tree finding,
        # README.md:103-106) — and carry zero discretization slack; the
        # fused kernels (nn.mxu) raise the exact cutoff where they compile
        if params.bound_backend == "auto":
            self._backend = auto_backend(params, self.tgt.shape[0])
        else:
            self._backend = params.bound_backend
        # progressive-screening kernel: fused epilogue + partial-lb early
        # exit (nn.mxu.bounds_nodes) — untrimmed solves only.  A partial sum
        # of the h smallest terms is no lower bound, so trimmed solves take
        # the unfused path even when bound_backend="screen" is forced.
        if self._backend in ("mxu", "screen"):
            untrimmed = params.trim_fraction == 0.0
            if self._backend == "screen" and not untrimmed:
                self.log.info(
                    "bound_backend='screen' is untrimmed-only; this trimmed "
                    "solve runs the unfused 'mxu' path"
                )
            self._backend = (
                "screen"
                if untrimmed and (params.screen or self._backend == "screen")
                else "mxu"
            )

        # Tight domain (target bbox × expand, ≙ jly's expandFactor=2 DT box,
        # jly_3ddt.cpp:889): queries landing outside get exact
        # triangle-inequality escape bounds, so shrinking the domain costs
        # nothing in correctness but divides the cell size — and with it the
        # discretization slack on every lower bound — by ~4 vs. covering the
        # whole reachable set.
        # ICP backend: exact NN while iters×N×Nt stays cheap (true SSE →
        # tighter incumbents), grid correspondences for huge targets
        self._icp_backend = (
            "exact" if self.tgt.shape[0] <= params.icp_exact_max else "grid"
        )
        need_bounds_grid = self._backend == "grid"
        need_icp_grid = self._icp_backend == "grid"
        need_n = (
            params.grid_resolution if (need_bounds_grid or need_icp_grid) else 8
        )
        need_index = need_icp_grid or not need_bounds_grid
        if (
            grid is not None
            and grid.values.shape[0] >= need_n
            and (grid.indices is not None or not need_index)
        ):
            # target-resident reuse (serving: one distance field amortized
            # over every query against the same target — serve.py)
            self.grid = grid
        else:
            with self.metrics.phase("grid_build"):
                # all-exact solvers get a vestigial 8³ field (evaluator
                # plumbing)
                self.grid = build_distance_grid(
                    self.tgt,
                    n=need_n,
                    expand=params.grid_expand,
                    method=params.grid_method,
                    with_index=need_index,
                )
                jax.block_until_ready(self.grid.values)
        self.ev = BoundsEvaluator(
            self.src,
            self.grid,
            trim_fraction=params.trim_fraction,
            lookup=params.lookup,
            conservative=params.conservative,
        )
        self.rotparam = _PARAMS[params.rotation_param]
        # SSEThresh = MSEThresh * inlierNum (jly_goicp.cpp:199-208)
        self.sse_thresh = params.mse_threshold * self.ev.h
        self._icp_params = IcpParams(
            max_iter=params.icp_max_iter,
            rel_tol=params.icp_rel_tol,
            trim_fraction=params.trim_fraction,
            metric=params.icp_metric,
        )
        # the SE(3)/multi-host IN-ROUND refine tail (se3.py:_refine_tail)
        # takes target normals, so it honors icp_metric="plane"; only the
        # mesh-sharded round (dist/se3.py shard_map, no normals plumbing)
        # keeps point-to-point — both refine directions are sound (run_icp
        # reports the best point-SSE pose either way)
        # in-round refines are incumbent DISCOVERY, capped at
        # refine_max_iter (the gate to fire them at all lives in the round
        # tail: ub < icp_refine_factor·best, ≙ fgoicp.cpp:75); the final
        # polish below re-runs at full icp_max_iter strength
        self._icp_params_round = dataclasses.replace(
            self._icp_params,
            max_iter=min(params.icp_max_iter, params.refine_max_iter),
        )
        self._icp_params_round_mesh = dataclasses.replace(
            self._icp_params_round, metric="point"
        )
        self._src_dev = jnp.asarray(self.src)
        self._tgt_dev = jnp.asarray(self.tgt)
        # plane-metric refinement descends the point-to-plane objective but
        # incumbents are ALWAYS the point-SSE best pose (run_icp's reported
        # sse is point-to-point in both metrics), so BnB pruning and the
        # ε-certificate are metric-independent
        # precomputed target normals (``normals=``) let a resident-target
        # caller (serve.RegistrationService) pay the PCA pass once instead
        # of per-query solver construction
        self._nrm_dev = None
        if params.icp_metric == "plane":
            self._nrm_dev = (
                jnp.asarray(normals, jnp.float32)
                if normals is not None
                else estimate_normals(self._tgt_dev, k=params.normals_k)
            )
        # exact-backend numerical slack: the f32 |t|²−2t·p+|p|² expansion can
        # misstate d² by ~8·ε_f32·scale², i.e. d by up to √(8·ε)·scale —
        # deducted from certified lower bounds (conservative mode only;
        # reference-parity mode ignores it, as both references ignore their
        # own grid error)
        scale = float(
            np.abs(self.src).max() + np.abs(self.tgt).max()
            + params.trans_span * _SQRT3
        )
        self._exact_slack = (
            math.sqrt(8.0 * 1.2e-7) * scale if params.conservative else 0.0
        )

    # -- batched ICP refinement (pad to icp_cap for a stable jit cache) ----

    def _refine(self, R: np.ndarray, t: np.ndarray):
        B = R.shape[0]
        cap = self.p.icp_cap
        outs = []
        for s in range(0, B, cap):
            e = min(s + cap, B)
            pad = cap - (e - s)
            Rb = np.concatenate([R[s:e], np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
            tb = np.concatenate([t[s:e], np.zeros((pad, 3), np.float32)])
            if self._icp_backend == "exact":
                res = _exact_icp(
                    self._src_dev,
                    self._tgt_dev,
                    jnp.asarray(Rb),
                    jnp.asarray(tb),
                    self._icp_params,
                    normals=self._nrm_dev,
                )
            else:
                res = _grid_icp(
                    self._src_dev,
                    self.grid,
                    self._tgt_dev,
                    jnp.asarray(Rb),
                    jnp.asarray(tb),
                    self._icp_params,
                    normals=self._nrm_dev,
                )
            # ONE device_get: separate np.asarray fetches each pay a full
            # device round trip
            Rb_, tb_, sse_, it_ = jax.device_get(
                (res.transform.R, res.transform.t, res.sse, res.iters)
            )
            outs.append(
                (Rb_[: e - s], tb_[: e - s], sse_[: e - s], it_[: e - s])
            )
        Rs = np.concatenate([o[0] for o in outs])
        ts = np.concatenate([o[1] for o in outs])
        sses = np.concatenate([o[2] for o in outs])
        iters = np.concatenate([o[3] for o in outs])
        return Rs, ts, sses, iters

    # -- scoring & full-resolution polish ----------------------------------

    def _score(self, R, t):
        """(Trimmed) solve-objective SSE at exact poses ``[B]`` via the ICP
        correspondence backend — the same measure the incumbents used."""
        params = IcpParams(
            max_iter=0, rel_tol=0.0, trim_fraction=self.p.trim_fraction
        )
        if self._icp_backend == "exact":
            res = _exact_icp(
                self._src_dev, self._tgt_dev,
                jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32), params,
            )
        else:
            res = _grid_icp(
                self._src_dev, self.grid, self._tgt_dev,
                jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32), params,
            )
        return np.asarray(res.sse)

    def _full_polish(self, best_R, best_t, best_sse):
        """Full-resolution ICP polish when the BnB solved on a
        ``bound_points`` subset.  The returned (pose, sse) pair stays
        consistent: the polished pose is re-scored on the solve objective
        and only accepted when it does not regress beyond ε/100."""
        if self.src_full.shape[0] <= self.src.shape[0]:
            return best_R, best_t, best_sse
        with self.metrics.phase("icp"):
            full = jnp.asarray(self.src_full)
            if self._icp_backend == "exact":
                pres = _exact_icp(
                    full, self._tgt_dev,
                    jnp.asarray(best_R[None]), jnp.asarray(best_t[None]),
                    self._icp_params, normals=self._nrm_dev,
                )
            else:
                pres = _grid_icp(
                    full, self.grid, self._tgt_dev,
                    jnp.asarray(best_R[None]), jnp.asarray(best_t[None]),
                    self._icp_params, normals=self._nrm_dev,
                )
            R_pp, t_pp, sse_pp, it_pp = jax.device_get(
                (pres.transform.R, pres.transform.t, pres.sse, pres.iters)
            )
            R_p, t_p = R_pp[0], t_pp[0]
            self.metrics.counters["full_polish_sse"] = float(sse_pp[0])
            self.metrics.count("icp_iters", int(it_pp[0]))
            sse_p = float(self._score(R_p[None], t_p[None])[0])
        if sse_p <= best_sse + 0.01 * self.sse_thresh:
            return R_p, t_p, sse_p
        return best_R, best_t, best_sse

    def score_full(self, R, t, trim_fraction: Optional[float] = None):
        """(Trimmed) SSE of the FULL source cloud at one pose, on the
        solver's resident correspondence backend — the single scoring pass
        behind :meth:`_full_cert` and the trimmed transfer in
        ``bnb.fullcert`` (one implementation, review r5 item 7)."""
        params = IcpParams(
            max_iter=0, rel_tol=0.0,
            trim_fraction=(
                self.p.trim_fraction if trim_fraction is None
                else trim_fraction
            ),
        )
        full = jnp.asarray(self.src_full)
        Rb = jnp.asarray(np.asarray(R, np.float32)[None])
        tb = jnp.asarray(np.asarray(t, np.float32)[None])
        if self._icp_backend == "exact":
            res = _exact_icp(full, self._tgt_dev, Rb, tb, params)
        else:
            res = _grid_icp(full, self.grid, self._tgt_dev, Rb, tb, params)
        return float(np.asarray(res.sse)[0])

    def _full_cert(self, best_R, best_t, best_sse, gap):
        """Full-cloud certificate under ``bound_points`` (see the field
        docs on :class:`GoIcpResult`): ``(sse_full, mse_full, gap_full)``,
        all None when the BnB solved the whole cloud.  One scoring pass on
        the full cloud; the transfer itself is the subset-⊆-full
        inequality, beating the reference's own unqualified subsample
        (``common.cpp:110-132`` certifies nothing beyond it)."""
        n_full = self.src_full.shape[0]
        if n_full <= self.src.shape[0]:
            return None, None, None
        sse_full = self.score_full(best_R, best_t)
        h_full = max(1, int(round(n_full * (1.0 - self.p.trim_fraction))))
        mse_full = sse_full / h_full
        if self.p.trim_fraction > 0.0:
            # no gap at EQUAL trim fractions — the h_full-smallest full
            # terms need not contain the h_sub-smallest subset terms, so
            # the subset-⊆-full inequality fails between trimmed sums.
            # The sound construction (the subset solve over-trims by the
            # FULL drop count: h_s = N_s − (N_f − h_f)) lives in
            # ``bnb.fullcert.register_full_cert``, which also drives the
            # gap down to ε by adaptive subset refinement.
            return sse_full, mse_full, None
        # The subset-optimum slack, by how the solve actually terminated:
        # - gap = −inf (frontier AND leaves exhausted): every region was
        #   pruned at ≥ best_then − ε with best_then ≥ best_final, so the
        #   guarantee is opt ≥ best − ε — the slack is ε, NOT 0 (a raw
        #   max(gap, 0) here would overclaim by ε — round-5 review fix);
        # - best ≤ ε (the threshold rule fired, possibly alongside a large
        #   gap): opt ≥ 0 ≥ best − ε, so the tighter min(gap, ε) is valid;
        # - otherwise only the gap form holds: opt ≥ best − gap (covers
        #   budget exhaustion AND the emptied-frontier-with-alive-leaf
        #   case, where `converged` is force-set but the leaf's true min
        #   may sit at its lb).
        # ``_full_polish`` may have accepted a pose up to +0.01·ε above the
        # pre-polish incumbent the pruning used — the bound carries that
        # acceptance slack too.
        if not math.isfinite(gap):
            slack_g = self.sse_thresh
        else:
            g = max(gap, 0.0)
            slack_g = (
                min(g, self.sse_thresh)
                if best_sse <= self.sse_thresh
                else g
            )
        sub_opt_lb = best_sse - slack_g - 0.01 * self.sse_thresh
        return sse_full, mse_full, float(
            max(sse_full - max(sub_opt_lb, 0.0), 0.0)
        )

    # -- initial incumbent -------------------------------------------------

    def _initial_icp(self, init: Optional[RigidTransform] = None):
        """Batched multi-start ICP (≙ the single identity start of
        fgoicp.cpp:11-18): identity + deterministic random rotations with
        centroid-matching translations.  One device step usually lands in
        the global basin, which the BnB then certifies (and prunes against)
        instead of discovers.

        Coarse-to-fine: when the clouds are large, all seeds first converge
        on a deterministic ``init_coarse_n``-point subset pair (NN cost
        divided by up to (N/n)·(Nt/n)), then only the best few — plus the
        identity and any caller seed, preserving the reference's start — are
        refined at full resolution.  The incumbent sse is always the
        full-resolution score, so BnB pruning stays exact."""
        p, m = self.p, self.metrics
        with m.phase("icp"):
            seeds = [np.eye(3, dtype=np.float32)]
            if init is not None:
                seeds.append(np.asarray(init.R, np.float32))
            k = max(0, p.init_multistart - len(seeds))
            if k:
                from goicp_tpu.geo.rotation import random_rotations

                seeds.append(random_rotations(k, np.random.default_rng(12345)))
            R0 = np.concatenate([s.reshape(-1, 3, 3) for s in seeds])
            mu_s, mu_t = self.src.mean(0), self.tgt.mean(0)
            t0 = mu_t[None, :] - np.einsum("bij,j->bi", R0, mu_s)
            if init is not None:
                t0[1] = np.asarray(init.t, np.float32)
            t0[0] = 0.0  # keep the reference's identity start exact
            t0 = t0.astype(np.float32)

            nc = p.init_coarse_n
            if 0 < nc < min(self.src.shape[0], self.tgt.shape[0]) // 2 \
                    and R0.shape[0] > 4:
                crng = np.random.default_rng(424242)
                src_c = self.src[
                    np.sort(crng.choice(self.src.shape[0], nc, replace=False))
                ]
                tidx = np.sort(
                    crng.choice(self.tgt.shape[0], nc, replace=False)
                )
                tgt_c = self.tgt[tidx]
                # index the FULL-cloud normals at the subset rows: cheaper
                # than re-running kNN+PCA on the thinned cloud every solve,
                # and strictly more accurate (subset-estimated normals see
                # ~nc/Nt of the local surface) — ADVICE r3
                nrm_c = (
                    None
                    if self._nrm_dev is None
                    else jnp.take(self._nrm_dev, jnp.asarray(tidx), axis=0)
                )
                cres = _exact_icp(
                    jnp.asarray(src_c), jnp.asarray(tgt_c),
                    jnp.asarray(R0), jnp.asarray(t0), self._icp_params,
                    normals=nrm_c,
                )
                cR, ct, c_sse, c_it = jax.device_get(
                    (cres.transform.R, cres.transform.t, cres.sse,
                     cres.iters)
                )
                m.count("icp_iters", int(c_it.sum()))
                keep = max(16, p.refine_top_k)
                top = np.argsort(c_sse)[:keep]
                pinned = [0] + ([1] if init is not None else [])
                sel = np.unique(np.concatenate([np.asarray(pinned), top]))
                # warm full-res starts from the coarse-converged poses
                # (pinned seeds keep their original exact starts)
                R0w = cR[sel]
                t0w = ct[sel]
                for j, s in enumerate(sel):
                    if s in pinned:
                        R0w[j], t0w[j] = R0[s], t0[s]
                R0, t0 = R0w.astype(np.float32), t0w.astype(np.float32)

            Rs, ts, sses, iters = self._refine(R0, t0)
            m.count("icp_iters", int(iters.sum()))
            j = int(np.argmin(sses))
            return Rs[j], ts[j], float(sses[j])

    # -- the solve ---------------------------------------------------------

    def run(self, init: Optional[RigidTransform] = None) -> GoIcpResult:
        p, m = self.p, self.metrics
        t_start = time.perf_counter()
        if max(p.mesh_cubes, p.mesh_points) > 1:
            self.log.warning(
                "engine='nested' runs single-device; mesh_cubes/mesh_points "
                "are honored by the SE(3) engine only (engine='se3')"
            )
        best_R, best_t, best_sse = self._initial_icp(init)
        self.log.info(
            "Initial ICP: sse=%.6g mse=%.6g", best_sse, best_sse / self.ev.h
        )

        frontier = make_cube_frontier()
        frontier.push(np.zeros((1, 3)), [self.rotparam.root_span], [0.0], [np.inf])
        rot_lb_leaf = float("inf")
        rounds = 0
        converged = best_sse <= self.sse_thresh  # ≙ fgoicp.cpp:21-24

        # checkpoint/resume: the nested loop is synchronous, so the frontier
        # plus incumbent is the complete search state at every round boundary
        import os

        if p.checkpoint_path and os.path.exists(p.checkpoint_path):
            ck = np.load(p.checkpoint_path)
            frontier = make_cube_frontier()
            pay = ck["payload"]
            frontier.push(pay[:, :3], pay[:, 3], ck["lb"], ck["ub"])
            if float(ck["best_sse"]) < best_sse:
                best_sse = float(ck["best_sse"])
                best_R, best_t = ck["best_R"], ck["best_t"]
            rot_lb_leaf = float(ck["leaf_lb"])
            rounds = int(ck["rounds"])
            m.count("rot_nodes", int(ck["nodes"]))
            self.log.info(
                "resumed from %s: round %d, frontier %d, best sse %.6g",
                p.checkpoint_path, rounds, len(frontier), best_sse,
            )

        def save_checkpoint():
            if not p.checkpoint_path:
                return
            pay, lb, ub = frontier.dump()
            tmp = p.checkpoint_path + ".tmp.npz"
            np.savez(
                tmp,
                payload=pay, lb=lb, ub=ub,
                best_R=best_R, best_t=best_t,
                best_sse=np.float32(best_sse),
                leaf_lb=np.float32(rot_lb_leaf),
                rounds=np.int64(rounds),
                nodes=np.int64(m.counters.get("rot_nodes", 0)),
            )
            os.replace(tmp, p.checkpoint_path)

        with m.phase("bnb"):
            while (
                not converged
                and len(frontier)
                and rounds < p.max_rounds
            ):
                gap_lb = min(frontier.min_lb(), rot_lb_leaf)
                if best_sse - gap_lb <= self.sse_thresh:  # ≙ fgoicp.cpp:44-47
                    converged = True
                    break
                if time.perf_counter() - t_start > p.max_wall_s:
                    self.log.warning(
                        "wall budget %.0fs exceeded at round %d (gap %.4g)",
                        p.max_wall_s,
                        rounds,
                        best_sse - gap_lb,
                    )
                    break
                rounds += 1
                cen, spn, _, _ = frontier.pop_best(p.rot_pop)
                # 8-way children (≙ fgoicp.cpp:53-60)
                half = (spn / 2.0)[:, None]
                ccen = (cen[:, None, :] + _OCTANTS[None] * half[:, None, :]).reshape(-1, 3)
                cspn = np.repeat(spn / 2.0, 8)
                ok = self.rotparam.valid(ccen, cspn)
                ccen, cspn = ccen[ok], cspn[ok]
                C = ccen.shape[0]
                if C == 0:
                    continue
                m.count("rot_nodes", C)
                R_c = self.rotparam.rotation(ccen)
                ang_c = self.rotparam.max_angle(ccen, cspn).astype(np.float32)

                # one device call runs the full dual-mode inner BnB for every
                # candidate; pad G to the static cap (stable jit cache)
                G_cap = 8 * p.rot_pop
                padn = G_cap - C
                R_pad = np.concatenate(
                    [R_c, np.tile(np.eye(3, dtype=np.float32), (padn, 1, 1))]
                )
                ang_pad = np.concatenate([ang_c, np.zeros(padn, np.float32)])
                # external caps: the ub search only matters below the ICP
                # trigger (refine_factor·best); the lb search below best.
                # Padding rows get -inf caps → die after one level.
                cap_ub = np.full(G_cap, p.icp_refine_factor * best_sse, np.float32)
                cap_lb = np.full(G_cap, best_sse, np.float32)
                if padn:
                    cap_ub[C:] = -np.inf
                    cap_lb[C:] = -np.inf
                inc_ub, inc_lb, t_g, unres_ub, unres_lb, nodes = inner_bnb_device(
                    self._src_dev,
                    self.ev.norms,
                    self.grid,
                    self._tgt_dev
                    if self._backend in ("exact", "mxu", "screen")
                    else self._tgt_dev[:1],
                    jnp.float32(
                        self._exact_slack
                        if self._backend in ("exact", "mxu", "screen")
                        else self.ev.slack
                    ),
                    jnp.asarray(R_pad),
                    jnp.asarray(ang_pad),
                    jnp.asarray(cap_ub),
                    jnp.asarray(cap_lb),
                    jnp.asarray(np.asarray(p.trans_center, np.float32)),
                    jnp.float32(p.trans_span),
                    jnp.float32(self.sse_thresh),
                    jnp.float32(p.min_trans_span),
                    levels=p.inner_levels,
                    C=p.inner_cap,
                    h=(self.ev.h if p.trim_fraction > 0 else 0),
                    lookup=p.lookup,
                    tile=p.point_tile,
                    # the nested device-inner loop has no fused-kernel path;
                    # mxu degrades to the XLA exact expansion there
                    backend=(
                        "exact" if self._backend in ("exact", "mxu", "screen")
                        else "grid"
                    ),
                )
                ub_c = np.asarray(inc_ub)[:C]
                lb_c = np.minimum(np.asarray(inc_lb), np.asarray(unres_lb))[:C]
                t_ub = np.asarray(t_g)[:C]
                m.count("trans_nodes", int(nodes))

                # ICP-refine all promising candidates in one batch
                # (≙ relaxed trigger, fgoicp.cpp:75) — plus, always, the
                # top-k best-ub candidates of the round: early on no cube
                # clears the trigger, yet refining the best few is nearly
                # free in a batched ICP step and finds incumbents fast
                promising = ub_c < p.icp_refine_factor * best_sse
                if p.refine_top_k and C > 0:
                    k = min(p.refine_top_k, C)
                    top = np.argpartition(ub_c, k - 1)[:k]
                    promising = promising.copy()
                    promising[top[np.isfinite(ub_c[top])]] = True
                if promising.any():
                    with m.phase("icp"):
                        Rs, ts, sses, iters = self._refine(
                            R_c[promising], t_ub[promising]
                        )
                    m.count("icp_iters", int(iters.sum()))
                    j = int(np.argmin(sses))
                    if float(sses[j]) < best_sse:
                        best_sse = float(sses[j])
                        best_R, best_t = Rs[j], ts[j]
                        dropped = frontier.prune(best_sse)
                        self.log.info(
                            "round %d: new best sse=%.6g (mse=%.6g), pruned %d cubes",
                            rounds,
                            best_sse,
                            best_sse / self.ev.h,
                            dropped,
                        )
                # direct incumbent update from bound evaluation
                j = int(np.argmin(ub_c))
                if float(ub_c[j]) < best_sse:
                    best_sse = float(ub_c[j])
                    best_R, best_t = R_c[j], t_ub[j]
                    frontier.prune(best_sse)

                # push surviving children (≙ fgoicp.cpp:97-101)
                alive = lb_c < best_sse - self.sse_thresh
                rot_floor = p.min_rot_span * self.rotparam.root_span
                at_floor = alive & (cspn / 2.0 < rot_floor)
                if at_floor.any():
                    rot_lb_leaf = min(rot_lb_leaf, float(lb_c[at_floor].min()))
                keep = alive & ~at_floor
                if keep.any():
                    frontier.push(ccen[keep], cspn[keep], lb_c[keep], ub_c[keep])

                if best_sse <= self.sse_thresh:
                    converged = True
                if p.checkpoint_path and rounds % max(p.checkpoint_every, 1) == 0:
                    save_checkpoint()
                if rounds % 10 == 0:
                    self.log.info(
                        "round %d: best=%.5g frontier=%d min_lb=%.4g leaf_lb=%.4g",
                        rounds, best_sse, len(frontier), frontier.min_lb(),
                        rot_lb_leaf,
                    )

                self.progress.publish(
                    SolverState(
                        opt_R=best_R,
                        opt_t=best_t,
                        cur_R=R_c[0],
                        cur_t=t_ub[0],
                        best_sse=best_sse,
                        gap=best_sse - min(frontier.min_lb(), rot_lb_leaf),
                        finished=False,
                        rot_nodes=int(m.counters["rot_nodes"]),
                        trans_nodes=int(m.counters["trans_nodes"]),
                        round=rounds,
                    )
                )

        if not len(frontier) and not converged:
            # frontier exhausted ⇒ search space fully covered to the span
            # floor: optimal within the floor resolution
            converged = True

        best_R, best_t, best_sse = self._full_polish(best_R, best_t, best_sse)

        gap = best_sse - min(frontier.min_lb(), rot_lb_leaf)
        sse_full, mse_full, gap_full = self._full_cert(
            best_R, best_t, best_sse, gap
        )
        wall = time.perf_counter() - t_start
        result = GoIcpResult(
            transform=RigidTransform(best_R, best_t),
            sse=best_sse,
            mse=best_sse / self.ev.h,
            converged=converged,
            gap=float(max(gap, 0.0)) if math.isfinite(gap) else 0.0,
            rot_nodes=int(self.metrics.counters["rot_nodes"]),
            trans_nodes=int(self.metrics.counters["trans_nodes"]),
            icp_iters=int(self.metrics.counters["icp_iters"]),
            rounds=rounds,
            wall_s=wall,
            metrics=self.metrics,
            sse_full=sse_full,
            mse_full=mse_full,
            gap_full=gap_full,
        )
        self.progress.publish(
            SolverState(
                opt_R=best_R,
                opt_t=best_t,
                cur_R=best_R,
                cur_t=best_t,
                best_sse=best_sse,
                gap=result.gap,
                finished=True,
                rot_nodes=result.rot_nodes,
                trans_nodes=result.trans_nodes,
                round=rounds,
            )
        )
        self.log.info(
            "Go-ICP done: sse=%.6g mse=%.6g rounds=%d rot_nodes=%d trans_nodes=%d wall=%.2fs",
            result.sse,
            result.mse,
            rounds,
            result.rot_nodes,
            result.trans_nodes,
            wall,
        )
        return result


def make_solver(
    src,
    tgt,
    params: BnbParams = BnbParams(),
    progress: Optional[ProgressBus] = None,
    local: bool = False,
    grid=None,
    normals=None,
    bound_idx=None,
) -> GoIcpSolver:
    """Engine dispatch: "se3" (flat product-space, default) or "nested".

    Under a multi-process ``jax.distributed`` launch (every process running
    the same program, one per host) the SE(3) engine routes to the
    frontier-sharded multi-host solver automatically — single-process
    behavior is untouched.  ``local=True`` pins the collective-free
    single-host engine even under multi-process (used when work is already
    partitioned at a higher level, e.g. pair sharding in
    ``multipair.register_pairs_distributed`` — hosts solving different
    problems must not issue solver collectives)."""
    if params.engine == "se3":
        if jax.process_count() > 1 and not local:
            from goicp_tpu.dist.multihost import GoIcpSolverMultiHost

            return GoIcpSolverMultiHost(
                src, tgt, params, progress, grid=grid, normals=normals,
                bound_idx=bound_idx,
            )
        from goicp_tpu.bnb.se3 import GoIcpSolverSE3

        return GoIcpSolverSE3(
            src, tgt, params, progress, grid=grid, normals=normals,
            bound_idx=bound_idx,
        )
    return GoIcpSolver(src, tgt, params, progress, grid=grid,
                       normals=normals, bound_idx=bound_idx)


def register(
    src,
    tgt,
    params: BnbParams = BnbParams(),
    progress: Optional[ProgressBus] = None,
) -> GoIcpResult:
    """One-call globally-optimal registration (≙ ``FastGoICP::run``)."""
    return make_solver(src, tgt, params, progress).run()
