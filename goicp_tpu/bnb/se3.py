"""Flat SE(3) product-space BnB — the batched global solver engine.

The reference nests two searches: an outer SO(3) BnB whose every node runs a
full inner R³ BnB to convergence (``fgoicp.cpp:32-181``; Yang et al. §IV).
That shape is right for a sequential CPU/stream machine and wrong for a wide
accelerator: the inner search is a *serial* loop of tiny batches, and
bounding its frontier to a fixed per-cube capacity (the jit-friendly
variant) silently weakens lower bounds whenever the capacity overflows.

This engine instead runs ONE best-first BnB over the 6-D product space
``SO(3) × R³``.  Each node is (rotation cube, translation cube) with

    ub = Σ_trim d(R_c p_i + t_c)²                                (exact pose)
    lb = Σ_trim max(d(R_c p_i + t_c) − γr_i − γt, 0)²     (Yang et al. eq. 10)

where ``γr_i = 2 sin(min(√3·σ_r, π)/2)·‖p_i‖`` (``jly_goicp.cpp:153-159``)
and ``γt = √3·σ_t``.  A node splits 8-way along whichever of its two cubes
contributes more uncertainty (``γ̄r`` vs ``γt``) — equalizing the two radii,
which is what makes the product search competitive with the nested one.

Everything the device sees is a flat, statically-shaped batch: pop the B best
nodes from the (native C++) frontier, expand to 8B children, evaluate all
bounds in ONE dispatch, ICP-refine every promising child in one batched
call, push survivors.  No nested loops, no capacity starvation, no
data-dependent shapes.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.bnb.frontier import make_frontier
from goicp_tpu.bnb.solver import (
    BnbParams,
    GoIcpResult,
    GoIcpSolver,
    _OCTANTS,
)
from goicp_tpu.core.progress import SolverState
from goicp_tpu.core.types import RigidTransform

_SQRT3 = math.sqrt(3.0)
_PREC = jax.lax.Precision.HIGHEST
_INF = np.float32(np.inf)  # numpy on purpose — see device_inner._INF

from goicp_tpu.bnb.se3_eval import (  # noqa: F401,E402  (stable re-exports)
    _deflate_and_reduce,
    _refine_tail,
    _trimmed_sum_bisect,
    evaluate_se3_groups_mxu,
    evaluate_se3_nodes,
    evaluate_se3_nodes_mxu,
    evaluate_se3_nodes_screened,
    se3_round,
    se3_round_grouped,
)

class GoIcpSolverSE3(GoIcpSolver):
    """Product-space engine (shares init/ICP plumbing with the nested solver).

    The per-round machinery — frontiers, expansion, bucketed dispatch,
    absorption — lives in the shared :class:`bnb.rounds.Se3RoundDriver`
    (also the multi-host engine's round core); this class owns only the
    pipelined dispatch/absorb loop, checkpoints, and diagnostics."""

    def run(self, init: Optional[RigidTransform] = None) -> GoIcpResult:
        import time

        p, m = self.p, self.metrics
        t_start = time.perf_counter()

        best_R, best_t, best_sse = self._initial_icp(init)
        self.log.info(
            "Initial ICP: sse=%.6g mse=%.6g", best_sse, best_sse / self.ev.h
        )

        rounds = 0
        converged = best_sse <= self.sse_thresh
        se3_pop = p.se3_pop or max(
            64, min(4096, int(32e6 / (8 * self.src.shape[0])))
        )
        M_cap = 8 * se3_pop

        # -- device mesh: shard each round's job batch over "cubes" and the
        # source cloud over "points" (VERDICT r1 item 1; the stream-pool axis
        # generalized, registration.cu:109-120).  1×1 mesh = the single-chip
        # fused round.  Always LOCAL devices (dist.se3.make_engine_mesh) —
        # under multi-process launches this engine may be running per-host
        # work (multipair pair slices) and must stay collective-free.
        from goicp_tpu.dist.se3 import make_engine_mesh

        mesh = None
        _mesh = make_engine_mesh(
            p, self._backend, self.src, np.asarray(self.ev.norms),
            h=(self.ev.h if p.trim_fraction > 0 else 0),
            icp_params=self._icp_params_round_mesh,
            icp_backend=self._icp_backend,
            log=self.log,
        )
        if _mesh is not None:
            sharded_round, src_pad_dev, norms_pad_dev, n_c, _ = _mesh
            M_cap = -(-M_cap // n_c) * n_c
            mesh = (sharded_round, src_pad_dev, norms_pad_dev, n_c)

        # center-aware rotation-cube angle bound, computed INSIDE the fused
        # round from (centers, spans) — strictly tighter than the host √3·σ
        # chordal form off-origin, so the certification tree shrinks.  In
        # the round program it costs one [M]-shaped epilogue and keeps the
        # round one dispatch.
        # Mesh rounds keep host angles (the sharded round has no tuple path).
        tight_ang = (
            p.tight_rot_bound
            and p.rotation_param == "axis_angle"
            and mesh is None
        )

        from goicp_tpu.bnb.rounds import Se3RoundDriver

        drv = Se3RoundDriver(
            self, pop_cap=se3_pop, M_cap=M_cap, bucket_base=2048,
            mesh=mesh, tight_ang=tight_ang, prune_on_best=True, diag=True,
        )
        drv.best_R, drv.best_t, drv.best_sse = best_R, best_t, best_sse
        drv.push_root()

        # resume from a frontier snapshot (restart-based recovery; the BnB
        # state is exactly {frontier, incumbent, counters} — SURVEY §5)
        import os
        from collections import deque

        inflight = deque()

        if p.checkpoint_path and os.path.exists(p.checkpoint_path):
            ck = np.load(p.checkpoint_path)
            drv.reset_frontiers()
            drv.push_classified(ck["payload"], ck["lb"], ck["ub"])
            if float(ck["best_sse"]) < drv.best_sse:
                drv.best_sse = float(ck["best_sse"])
                drv.best_R, drv.best_t = ck["best_R"], ck["best_t"]
            drv.leaf_lb = float(ck["leaf_lb"])
            rounds = int(ck["rounds"])
            m.count("se3_nodes", int(ck["nodes"]))
            self.log.info(
                "resumed from %s: round %d, frontier %d, best sse %.6g",
                p.checkpoint_path,
                rounds,
                drv.f_len(),
                drv.best_sse,
            )

        def save_checkpoint():
            if not p.checkpoint_path:
                return
            pay, lb, ub = drv.dump_frontiers()
            # Rounds still in flight hold nodes that are in neither the
            # frontier nor any pushed children; losing them would leave
            # permanently unexplored regions after a resume.  Re-include
            # their popped PARENTS (they get re-expanded — idempotent).
            for w in inflight:
                ppay, plb, pub = w["parents"]
                if ppay.shape[0]:
                    pay = np.concatenate([pay, ppay])
                    lb = np.concatenate([lb, plb])
                    ub = np.concatenate([ub, pub])
            tmp = p.checkpoint_path + ".tmp.npz"
            np.savez(
                tmp,
                payload=pay,
                lb=lb,
                ub=ub,
                best_R=drv.best_R,
                best_t=drv.best_t,
                best_sse=np.float32(drv.best_sse),
                leaf_lb=np.float32(drv.leaf_lb),
                rounds=np.int64(rounds),
                # in-flight parents get re-expanded on resume, so their
                # already-counted children must not be counted twice
                nodes=np.int64(
                    m.counters.get("se3_nodes", 0)
                    - sum(pt[-1] for w in inflight for pt in w["parts"])
                ),
            )
            os.replace(tmp, p.checkpoint_path)

        def _diag(work, ub_c, lb_c):
            """lb/threshold distribution + T-group survival (diagnostics):
            sizes the subset-lb screen — children with lb ≫ thresh are
            prunable from a cheap partial-sum bound over Ns/N points."""
            thr = max(drv.best_sse - self.sse_thresh, 1e-30)
            r = lb_c / thr
            for lo, hi in ((1, 2), (2, 3), (3, 4), (4, 6), (6, 8), (8, 12),
                           (12, 1e30)):
                m.count(f"lb_r_{lo}", int(((r >= lo) & (r < hi)).sum()))
            m.count("lb_r_alive", int((r < 1).sum()))
            if work.get("grouped"):
                # two-phase T-screen sizing: a group survives a subset
                # screen of Ns=N/k points roughly when min_j lb_full < k·thr
                gmin = lb_c.reshape(-1, 8).min(axis=1)
                m.count("tgroups", gmin.shape[0])
                m.count("tgroups_surv_quarter", int((gmin < 4 * thr).sum()))
                m.count("tgroups_surv_half", int((gmin < 2 * thr).sum()))

        def absorb(work):
            """Absorb one round, then the engine-side bookkeeping (converged
            flag, checkpoints, periodic logs, progress bus)."""
            nonlocal converged
            drv.absorb(work, post_update=_diag)
            if drv.best_sse <= self.sse_thresh:
                converged = True
            if p.checkpoint_path and rounds % max(p.checkpoint_every, 1) == 0:
                save_checkpoint()
            if rounds % 10 == 0:
                self.log.info(
                    "round %d: best=%.5g frontier=%d+%d min_lb=%.4g leaf_lb=%.4g",
                    rounds,
                    drv.best_sse,
                    len(drv.fR),
                    len(drv.fT),
                    drv.f_min_lb(),
                    drv.leaf_lb,
                )
            child0, _, R_c0, _, _ = work["parts"][0]
            self.progress.publish(
                SolverState(
                    opt_R=drv.best_R,
                    opt_t=drv.best_t,
                    cur_R=R_c0[0],
                    cur_t=child0[0, 4:7],
                    best_sse=drv.best_sse,
                    gap=drv.best_sse - min(drv.f_min_lb(), drv.leaf_lb),
                    finished=False,
                    rot_nodes=int(m.counters.get("se3_nodes", 0)),
                    trans_nodes=int(m.counters.get("se3_nodes", 0)),
                    round=rounds,
                )
            )

        # Up to pipeline_depth rounds in flight: round k+d is dispatched
        # (popping a *disjoint* frontier slice) before round k's results are
        # fetched, hiding host↔device latency.  Staleness only weakens
        # incumbent-driven pruning by a few rounds; every node is still
        # evaluated, so correctness is unaffected.
        budget_exceeded = False
        depth = max(1, p.pipeline_depth)
        with m.phase("bnb"):
            while True:
                if (
                    not budget_exceeded
                    and time.perf_counter() - t_start > p.max_wall_s
                ):
                    budget_exceeded = True
                    self.log.warning(
                        "wall budget %.0fs exceeded at round %d (gap %.4g)",
                        p.max_wall_s,
                        rounds,
                        drv.best_sse - min(drv.f_min_lb(), drv.leaf_lb),
                    )
                can_dispatch = (
                    rounds < p.max_rounds
                    and drv.f_len()
                    and not converged
                    and not budget_exceeded
                )
                if can_dispatch and not inflight:
                    # gap test only in a settled state: with rounds in
                    # flight the frontier is partially drained and min_lb
                    # would spuriously read high
                    gap_lb = min(drv.f_min_lb(), drv.leaf_lb)
                    if drv.best_sse - gap_lb <= self.sse_thresh:
                        converged = True
                        can_dispatch = False
                if can_dispatch and len(inflight) < depth:
                    rounds += 1
                    # best-first across both frontiers: pop the one whose
                    # best node is more promising (homogeneous round each way)
                    work = (
                        drv.dispatch_T(rounds)
                        if len(drv.fT) and drv.fT.min_lb() <= drv.fR.min_lb()
                        else drv.dispatch_singleton(drv.fR, rounds)
                    )
                    if work["parts"]:
                        inflight.append(work)
                    continue
                if inflight:
                    absorb(inflight.popleft())
                    continue
                gap_lb = min(drv.f_min_lb(), drv.leaf_lb)
                if (
                    converged
                    or drv.best_sse - gap_lb <= self.sse_thresh
                    or not drv.f_len()
                    or rounds >= p.max_rounds
                    or budget_exceeded
                ):
                    if (
                        drv.best_sse - gap_lb <= self.sse_thresh
                        or not drv.f_len()
                    ):
                        converged = True
                    break

        if not drv.f_len() and not converged:
            converged = True

        # full-resolution polish + consistent re-score (solver._full_polish)
        best_R, best_t, best_sse = self._full_polish(
            drv.best_R, drv.best_t, drv.best_sse
        )

        gap = best_sse - min(drv.f_min_lb(), drv.leaf_lb)
        sse_full, mse_full, gap_full = self._full_cert(
            best_R, best_t, best_sse, gap
        )
        wall = time.perf_counter() - t_start
        nodes = int(m.counters.get("se3_nodes", 0))
        result = GoIcpResult(
            transform=RigidTransform(best_R, best_t),
            sse=best_sse,
            mse=best_sse / self.ev.h,
            converged=converged,
            gap=float(max(gap, 0.0)) if math.isfinite(gap) else 0.0,
            rot_nodes=nodes,
            trans_nodes=nodes,
            icp_iters=int(m.counters.get("icp_iters", 0)),
            rounds=rounds,
            wall_s=wall,
            metrics=m,
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
                rot_nodes=nodes,
                trans_nodes=nodes,
                round=rounds,
            )
        )
        self.log.info(
            "Go-ICP(SE3) done: sse=%.6g mse=%.6g rounds=%d nodes=%d wall=%.2fs",
            result.sse,
            result.mse,
            rounds,
            nodes,
            wall,
        )
        return result
