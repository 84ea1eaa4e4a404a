"""Multi-HOST Go-ICP: the BnB frontier sharded across ``jax.process_count()``
processes (SURVEY §2 parallelism checklist, the PP/EP analogue — each host
expands a disjoint slice of the SE(3) frontier; the incumbent is a scalar
all-reduced each round; work rebalances over the process mesh).

The reference has no multi-process anything (SURVEY §5: "distributed
communication backend: none"); its closest analogue is the 32-stream pool
(``fgoicp.hpp:24``).  The single-process engine (``bnb.se3``) already shards
each round over an intra-process device mesh; this module adds the
*between-hosts* axis on top:

- **Disjoint partition.** Every process expands the same root; each pushes
  only the children whose global index ≡ ``process_id`` (mod P).  Local
  frontiers stay disjoint and jointly cover SE(3) — no duplicated work, no
  coordination needed to maintain the invariant (children inherit it).
- **Pipelined lockstep rounds + incumbent exchange.** Each loop iteration
  every process dispatches one fused device round ahead (up to
  ``pipeline_depth`` in flight, hiding host↔device latency exactly like
  the single-host engine) or absorbs the oldest, then joins one
  ``process_allgather`` carrying ``(best_sse, pose, min_lb, |work|)``.
  In-flight parents are counted in ``min_lb``/``|work|`` so the global
  ε-rule stays conservative while rounds are outstanding.  Pruning against
  a rounds-stale global incumbent is CONSERVATIVE: a stale best is never
  below the true best, so the prune threshold is never too tight —
  identical to the single-host pipelining argument (``bnb/se3.py``).
- **Local device mesh.** ``mesh_cubes``/``mesh_points`` give each process
  a (cubes × points) mesh over its own chips; rounds dispatch through
  ``dist.se3.make_sharded_se3_round`` with purely-local collectives, so
  the between-hosts lockstep is untouched.
- **Rebalancing.** Every 4 lockstep iterations, if any host cannot fill
  a round (< pop_cap) or the busiest frontier holds >2× the idlest (or any
  host is empty while work remains), each host pops up to ``exchange_k``
  best nodes FROM EACH of its two frontiers into a fixed-size buffer
  (inf-lb padded), allgathers, and re-partitions the merged set
  deterministically (sorted by lb, index mod P) — every node lands on
  exactly one host, so disjointness is preserved.
- **Termination.** Converged when ``global_best − min_p(min_lb_p) ≤ ε``
  or every frontier is empty — the distributed form of the ε-rule
  (``fgoicp.cpp:44``); all processes see the same reduced scalars, so they
  stop on the same iteration (no deadlocked collectives).

The per-round machinery (frontiers, expansion, bucketed dispatch,
absorption) is the shared :class:`bnb.rounds.Se3RoundDriver` — the same
object behind the single-host engine; this module owns only the lockstep
exchange, the root partition, rebalancing, and consistent-cut checkpoints.

Run one process per host with ``jax.distributed.initialize`` (tested
multi-process on a single machine with the Gloo CPU backend —
``tests/test_multihost.py``); on an accelerator cluster the same code
rides its interconnect.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils

from goicp_tpu.bnb.rounds import Se3RoundDriver
from goicp_tpu.bnb.solver import (
    GoIcpResult,
    GoIcpSolver,
)
from goicp_tpu.core.progress import SolverState
from goicp_tpu.core.types import RigidTransform


def _allgather_np(x: np.ndarray) -> np.ndarray:
    """Gather a same-shaped numpy array from every process → ``[P, ...]``."""
    return np.asarray(multihost_utils.process_allgather(jnp.asarray(x)))


class GoIcpSolverMultiHost(GoIcpSolver):
    """Frontier-sharded Go-ICP across processes.

    Every process constructs the solver with the SAME clouds and params and
    calls :meth:`run`; collectives keep them in lockstep.  With
    ``jax.process_count() == 1`` this is an (unpipelined) single-host SE(3)
    solve — useful as the correctness baseline in tests.
    """

    def run(self, init: Optional[RigidTransform] = None) -> GoIcpResult:
        p, m = self.p, self.metrics
        t_start = time.perf_counter()
        pid = jax.process_index()
        P = jax.process_count()

        best_R, best_t, best_sse = self._initial_icp(init)
        # all processes compute the same multistart (same seeds/data), but
        # f32 nondeterminism could disagree in the last ulp: align on the
        # global best so prune thresholds match exactly
        best_R, best_t, best_sse = self._exchange_incumbent(
            best_R, best_t, best_sse
        )
        self.log.info(
            "[p%d/%d] initial ICP: sse=%.6g", pid, P, best_sse
        )

        rounds = 0          # local work rounds (metrics only)
        pop_cap = p.se3_pop or 256

        # ---- optional intra-process device mesh: the between-hosts frontier
        # axis composes with a within-host (cubes × points) mesh — each
        # process shards ITS OWN rounds over its local chips (purely local
        # collectives, so lockstep across hosts is untouched).  ``mesh_cubes
        # = 0`` means every local device (mirroring the single-host engine).
        from goicp_tpu.dist.se3 import make_engine_mesh

        mesh = None
        _mesh = make_engine_mesh(
            p, self._backend, self.src, np.asarray(self.ev.norms),
            h=(self.ev.h if p.trim_fraction > 0 else 0),
            icp_params=self._icp_params_round_mesh,
            icp_backend=self._icp_backend,
            log=self.log,
            tag=f"[p{pid}/{P}] ",
        )
        if _mesh is not None:
            sharded_round, src_pad_dev, norms_pad_dev, n_c, _ = _mesh
            pop_cap = -(-pop_cap // n_c) * n_c
            mesh = (sharded_round, src_pad_dev, norms_pad_dev, n_c)

        M_cap = 8 * pop_cap
        # the shared round driver: multi-host keeps host angles (no
        # tight_ang device chaining), prunes after the lockstep exchange
        # (not inside absorb), buckets partial rounds from 256 (starved
        # hosts dispatch small rounds — measured 2026-08-20: without
        # bucketing every partial round costs a full-width dispatch and
        # 4-process efficiency collapses to 0.40), and pads mesh rounds to
        # the full cap (one compiled shape per kind under sharding)
        drv = Se3RoundDriver(
            self, pop_cap=pop_cap, M_cap=M_cap, bucket_base=256,
            mesh=mesh, tight_ang=None, prune_on_best=False, diag=False,
            sharded_pad_full=True,
            # interleaved 1.5× buckets measured SLOWER here (73 vs 60 s,
            # 4×1-core headline): the extra compiled shapes cost more than
            # the ~1% padding they save — see FUTURE.md round-5 ledger
        )
        drv.best_R, drv.best_t, drv.best_sse = best_R, best_t, best_sse
        root = drv.root

        # checkpoint/resume: each process snapshots ITS OWN frontier slice
        # (plus the exchanged incumbent) at the same global iteration, so
        # the P files form a consistent cut of the distributed search.
        # Resume requires the same process count and happens only if EVERY
        # process finds its slice (an allgathered flag keeps the decision
        # unanimous — a partial resume would double-cover SE(3) regions).
        import os

        ck_path = (
            f"{p.checkpoint_path}.p{pid}of{P}" if p.checkpoint_path else None
        )
        ck = None
        if ck_path and os.path.exists(ck_path):
            ck = np.load(ck_path)
        # resume requires a CONSISTENT CUT: every process must hold a slice
        # from the SAME lockstep iteration (a crash between two processes'
        # save calls leaves mixed-iteration files; rebalanced nodes could
        # then be in neither slice, silently dropping SE(3) regions).  The
        # gathered (have, it) pair keeps the decision unanimous.
        my_it = float(ck["it"]) if ck is not None and "it" in ck else -1.0
        allck = _allgather_np(np.float32([float(ck is not None), my_it]))
        resume = bool(
            allck[:, 0].min() > 0
            and allck[:, 1].max() == allck[:, 1].min()
            and allck[0, 1] >= 0
        )
        if ck is not None and not resume:
            self.log.warning(
                "[p%d/%d] checkpoint slices are not a consistent cut "
                "(iterations %s) — starting fresh",
                pid, P, allck[:, 1].tolist(),
            )
        if resume:
            drv.push_classified(ck["payload"], ck["lb"], ck["ub"])
            if float(ck["best_sse"]) < drv.best_sse:
                drv.best_sse = float(ck["best_sse"])
                drv.best_R, drv.best_t = ck["best_R"], ck["best_t"]
            drv.leaf_lb = float(ck["leaf_lb"])
            rounds = int(ck["rounds"])
            m.count("se3_nodes", int(ck["nodes"]))
            self.log.info(
                "[p%d/%d] resumed from %s: round %d, frontier %d, best %.6g",
                pid, P, ck_path, rounds, drv.f_len(), drv.best_sse,
            )
            # the checkpoint may re-include the ROOT itself (a crash while
            # round 1 was still in flight): its mod-P child partition must
            # re-fire on resume or every host would expand the full root
            root_pending = bool(
                np.any(np.all(np.abs(ck["payload"] - root[None]) < 1e-6,
                              axis=1))
            )
        else:
            # EVERY process pushes the root and expands it identically on
            # the first round, keeping only children with index ≡ pid
            # (mod P) — a disjoint exact cover with no coordination
            drv.push_root()
            root_pending = True
        # which frontier the root classifies into (deterministic — both the
        # fresh push above and any checkpoint re-inclusion use classify)
        _sr0, _lf0 = drv.classify(root[None])
        root_in_T = bool((~_sr0 & ~_lf0)[0])
        # GLOBAL lockstep iteration — advances on every process every loop,
        # so every collective-gating condition below derives from identical
        # values.  On resume it CONTINUES from the checkpoint (a monotone
        # counter): restarting at 0 would let checkpoint files from
        # different resume generations alias the same `it` and defeat the
        # consistent-cut check above.
        it = int(ck["it"]) if resume and "it" in ck else 0

        # rebalance constants must be IDENTICAL on every process (they gate
        # and size a collective), but pop_cap is rounded by the LOCAL mesh
        # extent — heterogeneous hosts would diverge.  One allgather at
        # init fixes the global values.
        pop_cap_g = int(_allgather_np(np.float32([pop_cap]))[:, 0].max())
        # per-frontier nodes offered into a rebalance: enough mass that a
        # starved host leaves with ≥ pop_cap work (the buffer rides one
        # small allgather — 2·k·10 f32 per host)
        exchange_k = max(64, 2 * pop_cap_g)
        converged = drv.best_sse <= self.sse_thresh

        from collections import deque

        inflight = deque()
        depth = max(1, p.pipeline_depth)

        def dispatch():
            """Pop + expand one HOMOGENEOUS local round and LAUNCH its
            kernel (async) through the shared driver; the results are
            fetched by :meth:`Se3RoundDriver.absorb`.  Purely local — no
            collectives — so processes may run different depths in flight.
            T-rounds ride the grouped 8-sibling kernel; R-rounds (and
            leaves) the singleton kernel.  While the ROOT is un-expanded
            (fresh start, or re-included by a resumed checkpoint) the round
            is forced singleton from the root's frontier: its mod-P child
            partition breaks 8-sibling blocks (the root may itself be a
            T-split)."""
            nonlocal root_pending
            use_T = (
                not root_pending
                and len(drv.fT)
                and (not len(drv.fR) or drv.fT.min_lb() <= drv.fR.min_lb())
            )
            if use_T:
                return drv.dispatch_T()
            if root_pending:
                src_f = (drv.fT if root_in_T else drv.fR)
                if not len(src_f):      # root not in this slice after all
                    src_f = drv.fR if len(drv.fR) else drv.fT
            else:
                src_f = drv.fR if len(drv.fR) else drv.fT

            def _partition_root(pay, child, keep):
                # the identical ROOT expansion partitions ITS children
                # across processes (per-parent: a resumed batch can mix the
                # root with ordinary nodes whose children are host-local);
                # afterwards each host owns its subtree slices
                nonlocal root_pending
                if root_pending:
                    root_rows = np.all(
                        np.abs(pay - root[None]) < 1e-6, axis=1
                    )
                    if root_rows.any():
                        if P > 1:
                            from_root = np.repeat(root_rows, 8)
                            child_idx = np.tile(np.arange(8), pay.shape[0])
                            keep = keep & (
                                ~from_root | (child_idx % P == pid)
                            )
                        root_pending = False
                return keep

            return drv.dispatch_singleton(
                src_f, child_filter=_partition_root
            )

        def save_checkpoint():
            """Atomic per-process snapshot.  In-flight rounds' popped parents
            are re-included (they are in neither the frontier nor any pushed
            children yet — same pipeline-safety rule as ``bnb/se3.py``)."""
            pay, lb, ub = drv.dump_frontiers()
            for w in inflight:
                ppay, plb, _pub = w["parents"]
                if ppay.shape[0]:
                    pay = np.concatenate([pay, ppay])
                    lb = np.concatenate([lb, plb])
                    ub = np.concatenate(
                        [ub, np.full(ppay.shape[0], np.inf, np.float32)]
                    )
            # in-flight parents get re-expanded on resume, so their
            # already-counted children must not be counted twice
            inflight_children = sum(
                pt[-1] for w in inflight for pt in w["parts"]
            )
            tmp = ck_path + ".tmp.npz"
            np.savez(
                tmp,
                payload=pay, lb=lb, ub=ub,
                best_R=drv.best_R, best_t=drv.best_t,
                best_sse=np.float32(drv.best_sse),
                leaf_lb=np.float32(drv.leaf_lb),
                rounds=np.int64(max(rounds, 1)),
                nodes=np.int64(
                    m.counters.get("se3_nodes", 0) - inflight_children
                ),
                nproc=np.int64(P),
                it=np.int64(it),
            )
            os.replace(tmp, ck_path)

        # exchange cadence: the allgather serializes behind the in-flight
        # rounds on the single device stream, so a per-iteration barrier
        # pays queue-drain + straggler skew + Gloo every round (measured:
        # 79% of the 4-proc wall inside the gather).  Exchanging every
        # `exch` iterations amortizes all three; every gating condition
        # stays a deterministic function of the global `it`, so the
        # collective count is identical on every process.
        exch = max(1, int(p.mh_exchange_every))
        ck_every = max(1, p.checkpoint_every // exch)   # in exchanges

        _bnb_phase = m.phase("bnb")
        _bnb_phase.__enter__()
        while True:
            it += 1
            # ---- local work: dispatch ahead up to `depth` rounds AND
            # absorb the oldest once saturated (one dispatch + one absorb
            # per lockstep iteration in steady state — full round rate with
            # a depth-deep pipeline).  The single-host pipelining argument
            # applies verbatim: staleness only weakens incumbent pruning;
            # every node is still evaluated.
            new_best = False
            if drv.f_len() and not converged and len(inflight) < depth:
                rounds += 1
                _t = time.perf_counter()
                work = dispatch()
                m.timers["mh_dispatch_s"] += time.perf_counter() - _t
                # phase breakdown (VERDICT r4 item 1): starved rounds run
                # under-filled batches; padded-slot waste is the bucket
                # width the kernel pays beyond the real jobs
                if work["n_parents"] < pop_cap:
                    m.count("mh_starved_rounds", 1)
                m.count("mh_jobs", sum(pt[-1] for pt in work["parts"]))
                m.count("mh_padded_jobs", work["width"])
                inflight.append(work)
            if inflight and (
                len(inflight) >= depth
                or not (drv.f_len() and not converged)
            ):
                _t = time.perf_counter()
                new_best = drv.absorb(inflight.popleft())
                m.timers["mh_absorb_s"] += time.perf_counter() - _t

            # ---- lockstep exchange (every process, every exch-th
            # iteration — same `it` everywhere, so no dangling collectives)
            if new_best:
                drv.f_prune(drv.best_sse - self.sse_thresh)
            if it % exch != 0:
                continue
            inflight_lb = min(
                (w["min_parent_lb"] for w in inflight), default=float("inf")
            )
            # ONE fused allgather carries incumbent (13f) AND status (3f) —
            # halving the per-iteration barrier crossings.  The status
            # slots are computed BEFORE the global-incumbent prune:
            # conservative (pre-prune min_lb is ≤ the post-prune value and
            # sizes are ≥), so the gap rule and the emptiness test can only
            # fire one iteration later, never early.
            rec = np.zeros(16, np.float32)
            rec[0] = drv.best_sse
            rec[1:10] = np.asarray(drv.best_R, np.float32).reshape(9)
            rec[10:13] = np.asarray(drv.best_t, np.float32)
            rec[13] = min(drv.f_min_lb(), drv.leaf_lb, inflight_lb)
            rec[14] = float(
                drv.f_len() + sum(w["n_parents"] for w in inflight)
            )
            rec[15] = float(
                it >= p.max_rounds
                or time.perf_counter() - t_start > p.max_wall_s
            )
            _t = time.perf_counter()
            allr = _allgather_np(rec)                      # [P, 16]
            # barrier + collective wait: on a fair-pinned rig this is
            # dominated by STRAGGLER SKEW (the slowest host's dispatch/
            # absorb), not by Gloo transfer — the breakdown separates them
            m.timers["mh_gather_s"] += time.perf_counter() - _t
            j = int(np.argmin(allr[:, 0]))
            if float(allr[j, 0]) <= drv.best_sse:
                # Adopt row j UNCONDITIONALLY on ties: on an exact f32 sse
                # tie between processes holding different poses, a strict <
                # would leave the tying process with its own pose while the
                # others adopt j's — breaking the cross-process bit-identical
                # pose invariant the headline record asserts.
                drv.best_sse = float(allr[j, 0])
                drv.best_R = allr[j, 1:10].reshape(3, 3)
                drv.best_t = allr[j, 10:13]
            drv.f_prune(drv.best_sse - self.sse_thresh)
            # `it` is global, so all P slices snapshot at the same cut
            # (checkpoint_every is interpreted in exchange units when the
            # cadence is wider — saves stay on exchange iterations)
            if ck_path and (it // exch) % ck_every == 0:
                save_checkpoint()
            g_min_lb = float(allr[:, 13].min())
            sizes = allr[:, 14]
            total = float(sizes.sum())

            if drv.best_sse <= self.sse_thresh:
                converged = True
            if drv.best_sse - g_min_lb <= self.sse_thresh or total == 0:
                converged = True
            if new_best or it % 16 == 0:
                _n = int(m.counters.get("se3_nodes", 0))
                self.progress.publish(SolverState(
                    opt_R=np.asarray(drv.best_R), opt_t=np.asarray(drv.best_t),
                    cur_R=np.asarray(drv.best_R), cur_t=np.asarray(drv.best_t),
                    best_sse=float(drv.best_sse),
                    gap=float(max(drv.best_sse - g_min_lb, 0.0)),
                    finished=False, rot_nodes=_n, trans_nodes=_n, round=it,
                ))
            # unanimous break: converged/g_min_lb/sizes are identical on all
            # processes and want_stop is max-reduced, so every process takes
            # this branch on the same iteration (no dangling collectives)
            if converged or allr[:, 15].max() > 0:
                break

            # ---- rebalance: even out frontiers ------------------------------
            force = sizes.min() == 0 and total > 0
            # rebalance whenever some host cannot fill a round (starved
            # rounds run half-empty batches — measured as the 4-host
            # efficiency cliff) or the spread exceeds 2×; every condition
            # derives from the allgathered sizes, so the decision is
            # unanimous and the collective count stays uniform
            if force or (
                it % 4 == 0
                and total > P * pop_cap_g / 2
                and (
                    sizes.min() < pop_cap_g
                    # 2× is deliberate: a tighter (1.25×) trigger was
                    # measured SLOWER (73.5 vs 68.4 s, 4×1-core bunny@0.01
                    # cert) — eager rebalancing pops each frontier's BEST
                    # nodes into the exchange and disturbs best-first
                    # locality more than the tail skew costs
                    or sizes.max() > 2 * max(sizes.min(), 1.0)
                )
            ):
                _t = time.perf_counter()
                payR, lbR, ubR = drv.fR.pop_best(exchange_k)
                payT, lbT, ubT = drv.fT.pop_best(exchange_k)
                pay = np.concatenate([payR, payT])
                lb = np.concatenate([lbR, lbT])
                ub = np.concatenate([ubR, ubT])
                buf = np.full((2 * exchange_k, 10), np.inf, np.float32)
                n = pay.shape[0]
                buf[:n, :8] = pay
                buf[:n, 8] = lb
                buf[:n, 9] = ub
                merged = _allgather_np(buf).reshape(-1, 10)
                real = np.isfinite(merged[:, 8])
                merged = merged[real]
                order = np.argsort(merged[:, 8], kind="stable")
                mine = order[pid::P]
                if mine.size:
                    drv.push_classified(
                        merged[mine, :8], merged[mine, 8], merged[mine, 9]
                    )
                m.count("rebalances", 1)
                m.timers["mh_rebalance_s"] += time.perf_counter() - _t

        # drain the pipeline: in-flight rounds may still hold a better
        # incumbent (their ICP refines were dispatched pre-convergence);
        # absorbing is local, then ONE unconditional exchange restores the
        # lockstep-identical incumbent (every process breaks on the same
        # iteration, so the collective count stays uniform)
        while inflight:
            drv.absorb(inflight.popleft())
        drv.best_R, drv.best_t, drv.best_sse = self._exchange_incumbent(
            drv.best_R, drv.best_t, drv.best_sse
        )
        m.counters["mh_iters"] = it
        _bnb_phase.__exit__(None, None, None)

        # full-resolution polish (bound_points-capped solves): the incumbent
        # is exchange-identical on every process and the polish is
        # deterministic with no collectives, so lockstep is preserved
        best_R, best_t, best_sse = self._full_polish(
            drv.best_R, drv.best_t, drv.best_sse
        )

        gap = best_sse - min(g_min_lb, drv.leaf_lb)
        wall = time.perf_counter() - t_start
        nodes = int(m.counters.get("se3_nodes", 0))
        self.log.info(
            "[p%d/%d] Go-ICP(multihost) done: sse=%.6g rounds=%d "
            "local_nodes=%d rebalances=%d wall=%.2fs",
            pid, P, best_sse, rounds, nodes,
            int(m.counters.get("rebalances", 0)), wall,
        )
        self.progress.publish(SolverState(
            opt_R=np.asarray(best_R), opt_t=np.asarray(best_t),
            cur_R=np.asarray(best_R), cur_t=np.asarray(best_t),
            best_sse=float(best_sse),
            gap=float(max(gap, 0.0)) if math.isfinite(gap) else 0.0,
            finished=True, rot_nodes=nodes, trans_nodes=nodes, round=rounds,
        ))
        # full-cloud certificate (deterministic, collective-free — every
        # process computes it from the exchange-identical incumbent)
        sse_full, mse_full, gap_full = self._full_cert(
            best_R, best_t, best_sse, gap
        )
        return GoIcpResult(
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

    def _exchange_incumbent(self, best_R, best_t, best_sse):
        """Global min-reduce of the incumbent (pose rides along)."""
        if jax.process_count() == 1:
            return best_R, best_t, best_sse
        rec = np.zeros(13, np.float32)
        rec[0] = best_sse
        rec[1:10] = np.asarray(best_R, np.float32).reshape(9)
        rec[10:13] = np.asarray(best_t, np.float32)
        allr = _allgather_np(rec)                          # [P, 13]
        j = int(np.argmin(allr[:, 0]))
        return (
            allr[j, 1:10].reshape(3, 3),
            allr[j, 10:13],
            float(allr[j, 0]),
        )
