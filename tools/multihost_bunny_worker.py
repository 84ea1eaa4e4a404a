"""Worker: one host of a REAL-bunny full ε-certification through
``GoIcpSolverMultiHost`` (Gloo CPU backend) — the headline-shaped multihost
workload (VERDICT r4 item 2).  Not a test module.

Usage: python multihost_bunny_worker.py <pid> <nproc> <port> <out.json> \
           <subsample> <mse_threshold>

The pair: the REAL bunny scan (``data/bunny/data_bunny.txt``) at
``subsample`` as the source; the target is the same cloud under a fixed
large rigid motion + σ=0.01 Gaussian noise.  With ``mse_threshold`` BELOW
the noise-floor optimum (≈2.7e-4 at subsample 0.01) the solve is a pure
ε-certification run to convergence via the gap rule — the headline shape.
The reference's own data-vs-model pair is NOT used because certifying it
to any sub-optimum ε is CPU-infeasible (>128k nodes with min_lb still 0
after 242 s/core at subsample 0.01, on a CPU core).

``nproc == 1`` runs the plain single-host SE(3) engine — the correctness
and efficiency baseline (make_solver auto-routes).
"""

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")

pid, nproc, port, out_path, subsample, thr = (
    int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    float(sys.argv[5]), float(sys.argv[6]),
)
if nproc > 1:
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )

import os

import numpy as np

from goicp_tpu.bnb import BnbParams, make_solver
from goicp_tpu.io import load_cloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
src = load_cloud(
    os.path.join(REPO, "data", "bunny", "data_bunny.txt"),
    subsample=subsample, seed=0,
)
rng = np.random.default_rng(77)
A = rng.normal(size=(3, 3))
Q, Ru = np.linalg.qr(A)
Q = (Q * np.sign(np.diag(Ru))).astype(np.float32)
if np.linalg.det(Q) < 0:
    Q[:, 0] *= -1
t_true = np.float32([0.12, -0.07, 0.09])
tgt = (
    src @ Q.T + t_true
    + rng.normal(size=src.shape).astype(np.float32) * 0.01
).astype(np.float32)

params = BnbParams(
    mse_threshold=thr,
    bound_backend="exact",     # the CPU-fast backend (grid needs a 256³
                               # EDT build per process; the kernel
                               # backends need a GPU)
    init_multistart=16,        # lands the incumbent; the wall is the tree
    se3_pop=int(os.environ.get("GOICP_MH_POP", "256") or 256),
    refine_top_k=4,
    pipeline_depth=int(os.environ.get("GOICP_MH_DEPTH", "3") or 3),
    mh_exchange_every=int(os.environ.get("GOICP_MH_EXCH", "0") or 0)
    or BnbParams().mh_exchange_every,
    max_rounds=20000,
    max_wall_s=1800.0,
)
res = make_solver(src, tgt, params).run()
pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
gt = src @ Q.T + t_true
with open(out_path, "w") as f:
    json.dump(
        {
            "pid": pid,
            "n_src": int(src.shape[0]),
            "converged": bool(res.converged),
            "mse": float(res.mse),
            "gap": float(res.gap),
            "rounds": int(res.rounds),
            "solver_wall_s": float(res.wall_s),
            "local_nodes": int(res.rot_nodes),
            "icp_iters": int(res.icp_iters),
            "rebalances": int(res.metrics.counters.get("rebalances", 0)),
            # per-phase breakdown (VERDICT r4 item 1): where the lockstep
            # wall goes on THIS host — host-side expansion, device wait,
            # allgather barrier (incl. straggler skew), rebalancing — plus
            # starvation and padded-slot waste
            "phases": {
                k: round(float(res.metrics.timers.get(k, 0.0)), 3)
                for k in ("mh_dispatch_s", "mh_absorb_s", "mh_gather_s",
                          "mh_rebalance_s")
            },
            "lockstep_iters": int(res.metrics.counters.get("mh_iters", 0)),
            "starved_rounds": int(
                res.metrics.counters.get("mh_starved_rounds", 0)
            ),
            "jobs": int(res.metrics.counters.get("mh_jobs", 0)),
            "padded_jobs": int(res.metrics.counters.get("mh_padded_jobs", 0)),
            "rmse_vs_gt": float(
                np.sqrt(np.mean(np.sum((pts - gt) ** 2, axis=1)))
            ),
            "R": np.asarray(res.transform.R).tolist(),
            "t": np.asarray(res.transform.t).tolist(),
        },
        f,
    )
print(f"[p{pid}] done", flush=True)
