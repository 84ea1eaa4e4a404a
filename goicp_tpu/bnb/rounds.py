"""Shared SE(3) round machinery — the round-driver object behind both the
single-host engine (``bnb.se3.GoIcpSolverSE3``) and the multi-host engine
(``dist.multihost.GoIcpSolverMultiHost``).

The two engines run the same per-round pipeline — pop a homogeneous batch
from split-type-partitioned frontiers, expand 8-way, pad to a job-count
bucket, launch one fused device round, absorb (incumbent + prune + push) —
and historically each carried its own copy as ~300 lines of closures inside
``run()``.  :class:`Se3RoundDriver` owns that machinery once; the engines
keep only what genuinely differs (the single-host pipeline loop and
diagnostics; the multi-host lockstep exchange, root partition, and
rebalancing), injected through constructor flags and small callbacks.

Behavioral knobs (each preserves its engine's exact semantics):

- ``bucket_base``: first job-count bucket (single-host 2048, multi-host 256).
- ``tight_ang``: center-aware cube angle bound, computed IN-PROGRAM from
  (centers, spans) shipped with the round (single-host, non-mesh only —
  mesh/multi-host keep host angles).
- ``prune_on_best``: prune both frontiers the moment ``absorb`` improves the
  incumbent (single-host); the multi-host engine prunes after its lockstep
  exchange instead, so a stale prune never races the exchanged incumbent.
- ``sharded_pad_full``: pad mesh rounds to the full cap (multi-host keeps
  every sharded dispatch one compiled shape) instead of the nearest bucket.
- ``diag``: pop/round-kind counters, per-kind timers, sampled T-pop
  rotation-uniqueness (single-host observability).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.bnb.frontier import make_frontier
from goicp_tpu.bnb.solver import _OCTANTS


class Se3RoundDriver:
    """Frontiers + expansion + fused-round dispatch + absorption for one
    SE(3) BnB engine instance.  ≙ the per-node stream loop of the reference
    (``registration.cu:109-151``) batched: one driver round is thousands of
    nodes through one device dispatch."""

    def __init__(
        self,
        solver,
        *,
        pop_cap: int,
        M_cap: int,
        bucket_base: int,
        mesh=None,
        tight_ang: bool = False,
        prune_on_best: bool = False,
        diag: bool = False,
        sharded_pad_full: bool = False,
        bucket_interleave: bool = False,
    ):
        self.s = solver
        self.m = solver.metrics
        self.pop_cap = pop_cap
        self.M_cap = M_cap
        self.mesh = mesh        # (sharded_round, src_pad, norms_pad, n_c)
        self.tight_ang = tight_ang
        self.prune_on_best = prune_on_best
        self.diag = diag
        self.sharded_pad_full = sharded_pad_full

        p = solver.p
        self.mean_norm = float(np.mean(np.linalg.norm(solver.src, axis=1)))
        self.rot_floor = p.min_rot_span * solver.rotparam.root_span
        self.trans_floor = max(p.min_trans_span, 1e-5)
        self.beta = max(p.split_beta, 1e-6)

        # TWO frontiers, partitioned by next-split type, so every device
        # round is HOMOGENEOUS: T-rounds run the grouped 8-sibling kernel at
        # full occupancy, R-rounds (and leaves) the singleton kernel.  A
        # mixed pop would pay both kernels at full padded width (~2× round
        # compute, measured).  Best-first order is preserved by popping
        # whichever frontier holds the smaller lb.
        self.fR = make_frontier(8)
        self.fT = make_frontier(8)

        self.best_R = None
        self.best_t = None
        self.best_sse = float("inf")
        self.leaf_lb = float("inf")

        self.root = np.array(
            [0.0, 0.0, 0.0, solver.rotparam.root_span,
             *p.trans_center, p.trans_span],
            np.float32,
        )

        # job-count buckets: compile a few round sizes instead of padding
        # every round to M_cap (measured 41% padded-slot waste single-host;
        # the 4-process efficiency collapse to 0.40 multi-host).  With
        # ``bucket_interleave`` the 1.5× midpoints join the ladder (the
        # serving-bucket trick): padded slots burn REAL compute on CPU
        # hosts, and the padding skew between lockstep hosts is a straggler
        # cost every exchange barrier pays — worth the extra compiled
        # shapes on the multi-host engine.
        buckets = []
        b = bucket_base
        while b < M_cap:
            buckets.append(b)
            if bucket_interleave and b + b // 2 < M_cap:
                buckets.append(b + b // 2)
            b *= 2
        buckets.append(M_cap)
        self._buckets = buckets

        self._h = solver.ev.h if p.trim_fraction > 0 else 0
        self._slack = jnp.float32(
            solver._exact_slack
            if solver._backend in ("exact", "mxu", "screen")
            else solver.ev.slack
        )

    # -- frontier management -------------------------------------------------

    def classify(self, pay):
        """Next split type per node (the ONE shared rule, ``bnb.split``)."""
        from goicp_tpu.bnb.split import classify_split

        return classify_split(
            pay, self.mean_norm, self.s.rotparam, beta=self.beta,
            rot_floor=self.rot_floor, trans_floor=self.trans_floor,
        )

    def push_classified(self, pay, lb, ub):
        split_rot, is_leaf = self.classify(pay)
        to_t = ~split_rot & ~is_leaf
        if to_t.any():
            self.fT.push(pay[to_t], lb[to_t], ub[to_t])
        if not to_t.all():
            self.fR.push(pay[~to_t], lb[~to_t], ub[~to_t])

    def push_root(self):
        self.push_classified(
            self.root[None],
            np.zeros(1, np.float32),
            np.full(1, np.inf, np.float32),
        )

    def reset_frontiers(self):
        self.fR = make_frontier(8)
        self.fT = make_frontier(8)

    def f_len(self) -> int:
        return len(self.fR) + len(self.fT)

    def f_min_lb(self) -> float:
        return min(self.fR.min_lb(), self.fT.min_lb())

    def f_prune(self, thr: float):
        self.fR.prune(thr)
        self.fT.prune(thr)

    def dump_frontiers(self):
        """(payload, lb, ub) of both frontiers concatenated (checkpoints)."""
        payR, lbR, ubR = self.fR.dump()
        payT, lbT, ubT = self.fT.dump()
        return (
            np.concatenate([payR, payT]),
            np.concatenate([lbR, lbT]),
            np.concatenate([ubR, ubT]),
        )

    def bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self.M_cap

    def thresh(self):
        """Incumbent − ε at dispatch time (the screened kernel's prune
        level; stale by up to pipeline_depth rounds — conservative)."""
        return jnp.float32(self.best_sse - self.s.sse_thresh)

    def refine_gate(self):
        """ICP-trigger level at dispatch time: only round candidates with
        ``ub < icp_refine_factor·best`` iterate the refine tail (≙ the
        relaxed trigger ``ub < best_sse*2``, ``fgoicp.cpp:75``).  Staleness
        (pipeline_depth rounds) only ever WIDENS the gate — the incumbent is
        monotone — so a stale gate costs extra refine work, never a missed
        candidate relative to the fresh gate."""
        return jnp.float32(self.s.p.icp_refine_factor * self.best_sse)

    # -- dispatch ------------------------------------------------------------

    def dispatch_T(self, round_idx: int = 0) -> dict:
        """Pop translation-split nodes → 8 octant t-children per parent,
        all sharing the parent rotation → one GROUPED device round
        (``se3_round_grouped``: the 8 siblings amortize the rotation's
        distance plane — ``nn.mxu`` docs)."""
        s, m, p = self.s, self.m, self.s.p
        pay, pop_lb, pop_ub = self.fT.pop_best(self.pop_cap)
        B = pay.shape[0]
        if self.diag:
            m.count("pops_trans", B)
        m.count("se3_nodes", 8 * B)
        # plane-merge potential: parents sharing a rotation payload could
        # share one grouped base plane (diagnostic for kernel batching).
        # Sampled every 16th round: the O(B log B) host row-sort is not
        # worth paying on every dispatch of the hot loop.
        if self.diag and round_idx % 16 == 1:
            m.count("uniq_rot_in_tpops_sampled",
                    int(np.unique(pay[:, 0:4], axis=0).shape[0]))
            m.count("tpops_sampled", B)

        half_t = pay[:, 7] / 2.0                    # [B]
        t8 = pay[:, None, 4:7] + _OCTANTS[None] * half_t[:, None, None]
        t8 = t8.astype(np.float32)                  # [B,8,3]
        R_g = s.rotparam.rotation(pay[:, 0:3])      # [B,3,3]
        ang_g = s.rotparam.max_angle(pay[:, 0:3], pay[:, 3]).astype(
            np.float32
        )
        # child payloads, group-major (kernel output order)
        child = np.repeat(pay, 8, axis=0)
        child[:, 4:7] = t8.reshape(8 * B, 3)
        child[:, 7] = np.repeat(half_t, 8)
        C = 8 * B

        G_cap = (
            self.pop_cap
            if (self.mesh is not None and self.sharded_pad_full)
            else self.bucket(C) // 8
        )
        padg = G_cap - B
        R_pad = np.concatenate(
            [R_g, np.tile(np.eye(3, dtype=np.float32), (padg, 1, 1))]
        )
        ang_pad = np.concatenate([ang_g, np.zeros(padg, np.float32)])
        t8_pad = np.concatenate([t8, np.zeros((padg, 8, 3), np.float32)])
        ts8 = np.repeat(half_t, 8).reshape(B, 8)
        ts8_pad = np.concatenate([ts8, np.zeros((padg, 8), np.float32)])
        mask = np.zeros(8 * G_cap, bool)
        mask[:C] = True

        if self.mesh is not None:
            out = self._dispatch_sharded(
                np.repeat(R_pad, 8, axis=0),
                np.repeat(ang_pad, 8),
                t8_pad.reshape(-1, 3),
                ts8_pad.reshape(-1),
                mask,
            )
        else:
            from goicp_tpu.bnb.se3 import se3_round_grouped

            # tight bound: ship (centers, spans) and compute the angle
            # IN-PROGRAM (tuple form of max_angle — see se3_round docs: a
            # round stays one dispatch)
            ang_in = (
                (
                    jnp.asarray(
                        np.concatenate(
                            [pay[:, 0:3], np.zeros((padg, 3), np.float32)]
                        )
                    ),
                    jnp.asarray(
                        np.concatenate([pay[:, 3], np.zeros(padg, np.float32)])
                    ),
                )
                if self.tight_ang
                else jnp.asarray(ang_pad)
            )
            out = se3_round_grouped(
                s._src_dev,
                s.ev.norms,
                s.grid,
                s._tgt_dev,
                s._nrm_dev,
                self._slack,
                self.thresh(),
                jnp.asarray(R_pad),
                ang_in,
                jnp.asarray(t8_pad),
                jnp.asarray(ts8_pad),
                jnp.asarray(mask),
                h=self._h,
                lookup=p.lookup,
                backend=s._backend,
                tile=p.point_tile,
                tgt_tile=256,
                refine_k=p.refine_top_k,
                icp_params=s._icp_params_round,
                icp_backend=s._icp_backend,
                refine_gate=self.refine_gate(),
            )
        return {
            "parts": [(child, np.zeros(C, bool),
                       np.repeat(R_g, 8, axis=0), out, C)],
            "parents": (pay, pop_lb, pop_ub),
            "grouped": B,
            "round": round_idx,
            "t0": time.perf_counter(),
            "n_parents": B,
            "min_parent_lb": float(pop_lb.min()) if B else float("inf"),
            "width": 8 * G_cap,          # padded job width (waste accounting)
        }

    def dispatch_singleton(
        self,
        frontier,
        round_idx: int = 0,
        child_filter: Optional[Callable] = None,
    ) -> dict:
        """Pop from ``frontier`` (usually fR: rotation splits + leaves, but
        the multi-host root round may pop fT) → octant children as singleton
        jobs → one singleton device round.  ``child_filter(pay, child, keep)
        → keep`` lets the multi-host engine partition the root's children
        mod-P."""
        s, m = self.s, self.m
        pay, pop_lb, pop_ub = frontier.pop_best(self.pop_cap)
        B = pay.shape[0]
        split_rot, is_leaf = self.classify(pay)
        if self.diag:
            m.count("pops_rot", int(split_rot.sum()))
            m.count("pops_leaf", int(is_leaf.sum()))
        child = np.repeat(pay, 8, axis=0)          # [8B, 8]
        oct8 = np.tile(_OCTANTS, (B, 1))           # [8B, 3]
        sr = np.repeat(split_rot, 8)
        lf = np.repeat(is_leaf, 8)
        half_r = np.repeat(pay[:, 3], 8) / 2.0
        half_t = np.repeat(pay[:, 7], 8) / 2.0
        tr = ~sr & ~lf    # only possible while the multi-host root pends
        child[sr, 0:3] += oct8[sr] * half_r[sr, None]
        child[sr, 3] = half_r[sr]
        child[tr, 4:7] += oct8[tr] * half_t[tr, None]
        child[tr, 7] = half_t[tr]
        # leaves: keep only one copy (slot 0 of each 8-block)
        keep = np.ones(8 * B, bool)
        if lf.any():
            keep &= ~lf | (np.arange(8 * B) % 8 == 0)
        # rotation-ball validity (jly_goicp.cpp:443-446)
        keep &= s.rotparam.valid(child[:, 0:3], child[:, 3])
        if child_filter is not None:
            keep = child_filter(pay, child, keep)
        child, lf = child[keep], lf[keep]
        C = child.shape[0]
        parts = []
        width = 0
        if C:
            assert C <= self.M_cap
            m.count("se3_nodes", C)
            out, R_c, width = self._eval_singleton(child)
            parts = [(child, lf, R_c, out, C)]
        return {
            "parts": parts,
            "parents": (pay, pop_lb, pop_ub),
            "round": round_idx,
            "t0": time.perf_counter(),
            "n_parents": B,
            "min_parent_lb": float(pop_lb.min()) if B else float("inf"),
            "width": width,              # padded job width (waste accounting)
        }

    def _eval_singleton(self, child):
        """Pad ``child [C,8]`` payloads to a bucket and launch one fused
        singleton round (async).  Returns ``(out, R_c, width)``."""
        s, p = self.s, self.s.p
        C = child.shape[0]
        cap = (
            self.M_cap
            if (self.mesh is not None and self.sharded_pad_full)
            else self.bucket(C)
        )
        padn = cap - C
        R_c = s.rotparam.rotation(child[:, 0:3])
        ang_c = s.rotparam.max_angle(child[:, 0:3], child[:, 3]).astype(
            np.float32
        )
        if self.mesh is not None:
            out = self._dispatch_sharded(
                np.concatenate(
                    [R_c, np.tile(np.eye(3, dtype=np.float32), (padn, 1, 1))]
                ),
                np.concatenate([ang_c, np.zeros(padn, np.float32)]),
                np.concatenate(
                    [child[:, 4:7], np.zeros((padn, 3), np.float32)]
                ),
                np.concatenate([child[:, 7], np.zeros(padn, np.float32)]),
                np.concatenate([np.ones(C, bool), np.zeros(padn, bool)]),
            )
            return out, R_c, cap
        from goicp_tpu.bnb.se3 import se3_round

        ang_in = (
            (
                jnp.asarray(
                    np.concatenate(
                        [child[:, 0:3], np.zeros((padn, 3), np.float32)]
                    )
                ),
                jnp.asarray(
                    np.concatenate([child[:, 3], np.zeros(padn, np.float32)])
                ),
            )
            if self.tight_ang
            else jnp.asarray(np.concatenate([ang_c, np.zeros(padn, np.float32)]))
        )
        out = se3_round(
            s._src_dev,
            s.ev.norms,
            s.grid,
            s._tgt_dev,
            s._nrm_dev,
            self._slack,
            self.thresh(),
            jnp.asarray(
                np.concatenate(
                    [R_c, np.tile(np.eye(3, dtype=np.float32), (padn, 1, 1))]
                )
            ),
            ang_in,
            jnp.asarray(
                np.concatenate([child[:, 4:7], np.zeros((padn, 3), np.float32)])
            ),
            jnp.asarray(np.concatenate([child[:, 7], np.zeros(padn, np.float32)])),
            jnp.asarray(np.concatenate([np.ones(C, bool), np.zeros(padn, bool)])),
            h=self._h,
            lookup=p.lookup,
            backend=s._backend,
            tile=p.point_tile,
            tgt_tile=256,
            refine_k=p.refine_top_k,
            icp_params=s._icp_params_round,
            icp_backend=s._icp_backend,
            refine_gate=self.refine_gate(),
        )
        return out, R_c, cap

    def _dispatch_sharded(self, R_c, ang_c, t_c, t_s, mask):
        """Launch the mesh round on flat job arrays (both round kinds),
        padding the job axis to a multiple of the cube-mesh extent."""
        s = self.s
        sharded_round, src_pad_dev, norms_pad_dev, n_c = self.mesh
        Mj = R_c.shape[0]
        Mpad = -(-Mj // (n_c or 1)) * (n_c or 1) - Mj
        if Mpad:
            R_c = np.concatenate(
                [R_c, np.tile(np.eye(3, dtype=np.float32), (Mpad, 1, 1))]
            )
            ang_c = np.concatenate([ang_c, np.zeros(Mpad, np.float32)])
            t_c = np.concatenate([t_c, np.zeros((Mpad, 3), np.float32)])
            t_s = np.concatenate([t_s, np.zeros(Mpad, np.float32)])
            mask = np.concatenate([mask, np.zeros(Mpad, bool)])
        return sharded_round(
            src_pad_dev,
            norms_pad_dev,
            s.grid,
            s._tgt_dev,
            self._slack,
            self.thresh(),
            jnp.asarray(R_c),
            jnp.asarray(ang_c),
            jnp.asarray(t_c),
            jnp.asarray(t_s),
            jnp.asarray(mask),
            s._src_dev,
            self.refine_gate(),
        )

    # -- absorb --------------------------------------------------------------

    def absorb(self, work: dict, post_update: Optional[Callable] = None):
        """Fetch one in-flight round; update the incumbent, (optionally)
        prune, update leaf_lb, push surviving children.  Returns whether
        the incumbent improved.  ``post_update(work, ub_c, lb_c)`` runs
        after the incumbent updates and before the survivor push (the
        single-host engine's diagnostics hook)."""
        s, m = self.s, self.m
        new_best = False
        for child, lf, R_c, out, C in work["parts"]:
            ub_d, lb_d, R_ref, t_ref, sse_ref, it_ref = jax.device_get(out)
            if self.diag:
                # dispatch→fetch latency per round kind (true per-kind device
                # wall at pipeline_depth=1; overlapped and only indicative
                # deeper)
                m.timers[
                    "round_T_s" if work.get("grouped") else "round_R_s"
                ] += time.perf_counter() - work["t0"]
            ub_c, lb_c = ub_d[:C], lb_d[:C]
            m.count("icp_iters", int(it_ref.sum()))

            j = int(np.argmin(sse_ref))
            if float(sse_ref[j]) < self.best_sse:
                self.best_sse = float(sse_ref[j])
                self.best_R, self.best_t = R_ref[j], t_ref[j]
                new_best = True
                if self.prune_on_best:
                    self.f_prune(self.best_sse - s.sse_thresh)
                    s.log.info(
                        "round %d: new best sse=%.6g (mse=%.6g)",
                        work.get("round", 0),
                        self.best_sse,
                        self.best_sse / s.ev.h,
                    )
            j = int(np.argmin(ub_c))
            if float(ub_c[j]) < self.best_sse:
                self.best_sse = float(ub_c[j])
                self.best_R, self.best_t = R_c[j], child[j, 4:7]
                new_best = True
                if self.prune_on_best:
                    self.f_prune(self.best_sse - s.sse_thresh)

            if post_update is not None:
                post_update(work, ub_c, lb_c)

            alive = lb_c < self.best_sse - s.sse_thresh
            if (alive & lf).any():
                self.leaf_lb = min(
                    self.leaf_lb, float(lb_c[alive & lf].min())
                )
            keep = alive & ~lf
            if keep.any():
                self.push_classified(child[keep], lb_c[keep], ub_c[keep])
        return new_best
