#!/usr/bin/env python3
"""A/B of the fused Pallas bound kernels against the plain XLA versions,
on the GPU, at bunny@0.05 widths (N = 1518 sources, Nt = 1797 targets).

    python tools/kernel_ab.py [--e2e] [--budget SECONDS] [--out PATH]

Kernel alone (host clock around ``block_until_ready``, median of 5 warm
calls), for each round-level bound evaluator:

- singleton rounds: ``evaluate_se3_nodes_screened`` (fused kernel, screen
  off and at a median-lb threshold) vs ``evaluate_se3_nodes_mxu``
  (per-point kernel + XLA epilogue) vs the XLA elementwise brute force
  (``nn.brute.min_dist_sq``) vs ``evaluate_se3_nodes`` with
  ``backend="exact"`` (XLA ``|q|² − 2q·m + |m|²`` matmul form);
- T-rounds: ``evaluate_se3_groups_mxu`` (grouped kernel) vs the same
  nodes as singletons and the XLA elementwise form;
- a block-size sweep of both kernels, the ICP nearest-neighbour step
  (XLA), and the compile time of the exact-``top_k`` normal estimate.

``--e2e`` adds the certified bunny solve of ``chip_smoke.py`` phase 4 with
``bound_backend`` forced to the kernels (screen) and to plain XLA (exact),
in turns (screen, exact, exact, screen).  Every line names the card; a JSON record
goes to ``--out`` (default ``chiprun_out/kernel_ab.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(fn, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--budget", type=float, default=120.0,
                    help="max_wall_s of each end-to-end solve")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "kernel_ab.json"))
    args = ap.parse_args()

    from goicp_tpu.core.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from goicp_tpu.bnb.se3 import (
        evaluate_se3_groups_mxu,
        evaluate_se3_nodes,
        evaluate_se3_nodes_mxu,
        evaluate_se3_nodes_screened,
    )
    from goicp_tpu.geo.rotation import random_rotations
    from goicp_tpu.nn import mxu
    from goicp_tpu.nn.brute import min_dist_sq, nearest_neighbor
    from goicp_tpu.nn.grid import build_distance_grid

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("kernel_ab.py measures the GPU; no GPU found", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    rec = {"card": card, "device_kind": dev.device_kind, "kernel": {}}
    print(f"card: {card}", flush=True)

    _, _, src, tgt, R_gt, t_gt = cs.bunny()
    src, tgt = src[: cs.N_SRC], tgt[: cs.N_TGT]
    norms = jnp.asarray(np.linalg.norm(src, axis=1), jnp.float32)
    src_d, tgt_d = jnp.asarray(src), jnp.asarray(tgt)
    grid = build_distance_grid(tgt, n=8, method="brute")
    rng = np.random.default_rng(7)

    def jobs(M):
        R = random_rotations(M, rng).astype(np.float32)
        t = (tgt.mean(0) - np.einsum("bij,j->bi", R, src.mean(0))
             + rng.uniform(-0.05, 0.05, (M, 3))).astype(np.float32)
        return (jnp.asarray(R), jnp.asarray(rng.uniform(0, 0.2, M), jnp.float32),
                jnp.asarray(t), jnp.asarray(rng.uniform(0, 0.03, M), jnp.float32),
                jnp.ones((M,), bool))

    def report(key, secs, pairs):
        rec["kernel"][key] = {"s": secs, "G_pairs_per_s": pairs / secs / 1e9}
        print(f"{key}: {secs * 1e3:.3f} ms  ({pairs / secs / 1e9:.1f} G "
              f"pairs/s)  [{card}]", flush=True)

    z = jnp.float32(0.0)
    inf = jnp.float32(np.inf)
    # XLA's elementwise min-reduce compiles for minutes on the GPU beyond a
    # few thousand nodes, so the XLA forms are timed at M = 2048 only
    for M in (2048, 8192):
        R, ang, t, ts, mask = jobs(M)
        pairs = M * src.shape[0] * tgt.shape[0]
        report(f"singleton M={M} fused kernel (screen off)", timed(
            lambda: evaluate_se3_nodes_screened(
                src_d, norms, tgt_d, z, inf, R, ang, t, ts, mask, h=0)), pairs)
        _, lb = evaluate_se3_nodes_screened(
            src_d, norms, tgt_d, z, inf, R, ang, t, ts, mask, h=0)
        thr = jnp.float32(np.median(np.asarray(lb)))
        report(f"singleton M={M} fused kernel (screen at median lb)", timed(
            lambda: evaluate_se3_nodes_screened(
                src_d, norms, tgt_d, z, thr, R, ang, t, ts, mask, h=0)), pairs)
        report(f"singleton M={M} per-point kernel + XLA epilogue", timed(
            lambda: evaluate_se3_nodes_mxu(
                src_d, norms, tgt_d, z, R, ang, t, ts, mask, h=0)), pairs)
        if M > 2048:
            continue
        pts = jnp.einsum("bij,nj->bni", R, src_d,
                         precision=jax.lax.Precision.HIGHEST) + t[:, None, :]
        report(f"singleton M={M} XLA elementwise min d2 (nn.brute)", timed(
            lambda: min_dist_sq(pts, tgt_d)), pairs)
        report(f"singleton M={M} XLA exact (matmul form)", timed(
            lambda: evaluate_se3_nodes(
                src_d, norms, grid, tgt_d, z, R, ang, t, ts, mask, h=0,
                lookup="nearest", backend="exact", tile=128, tgt_tile=256)),
            pairs)

    for G in (256, 1024):
        R, ang, t, _, _ = jobs(G)
        t8 = t[:, None, :] + jnp.asarray(
            rng.uniform(-0.02, 0.02, (G, 8, 3)), jnp.float32)
        ts8 = jnp.full((G, 8), 0.01, jnp.float32)
        mask = jnp.ones((8 * G,), bool)
        pairs = 8 * G * src.shape[0] * tgt.shape[0]
        report(f"grouped G={G} kernel", timed(
            lambda: evaluate_se3_groups_mxu(
                src_d, norms, tgt_d, z, R, ang, t8, ts8, mask, h=0)), pairs)
        Rf = jnp.repeat(R, 8, axis=0)
        report(f"grouped G={G} as singletons, per-point kernel", timed(
            lambda: evaluate_se3_nodes_mxu(
                src_d, norms, tgt_d, z, Rf, jnp.repeat(ang, 8),
                t8.reshape(-1, 3), ts8.reshape(-1), mask, h=0)), pairs)
        if G == 256:
            pts = jnp.einsum("bij,nj->bni", Rf, src_d,
                             precision=jax.lax.Precision.HIGHEST) \
                + t8.reshape(-1, 3)[:, None, :]
            report(f"grouped G={G} XLA elementwise min d2 (nn.brute)",
                   timed(lambda: min_dist_sq(pts, tgt_d)), pairs)

    # block-size sweeps of the raw kernels
    R, ang, t, ts, _ = jobs(8192)
    af = 2.0 * jnp.sin(jnp.minimum(ang, jnp.pi) / 2.0)
    params = mxu.pack_params_bounds(R, t, af, 1.7 * ts, 0.0, 1e30)
    pairs = 8192 * src.shape[0] * tgt.shape[0]
    for bn, bm, nw, ns in ((128, 32, 4, 2), (128, 16, 4, 2), (256, 32, 8, 2),
                           (128, 64, 8, 2), (64, 32, 2, 2)):
        try:
            report(f"sweep bounds_nodes bn={bn} bm={bm} warps={nw} "
                   f"stages={ns}", timed(lambda: mxu.bounds_nodes(
                       src_d, norms, tgt_d, params, bn=bn, bm=bm,
                       num_warps=nw, num_stages=ns)), pairs)
        except Exception as e:  # a config the compiler refuses
            print(f"sweep bounds_nodes bn={bn} bm={bm} warps={nw}: "
                  f"{type(e).__name__}: {str(e)[:200]}", flush=True)
    gp = mxu.pack_group_params(R[:1024], t[:1024, None, :] + jnp.zeros(
        (1024, 8, 3)))
    pairs = 8 * 1024 * src.shape[0] * tgt.shape[0]
    for bn, bm, nw in ((128, 8, 4), (128, 4, 4), (128, 16, 8), (64, 8, 2),
                       (256, 8, 8)):
        try:
            report(f"sweep min_d2_groups bn={bn} bm={bm} warps={nw}",
                   timed(lambda: mxu.min_d2_groups(
                       src_d, tgt_d, gp, bn=bn, bm=bm, num_warps=nw)), pairs)
        except Exception as e:
            print(f"sweep min_d2_groups bn={bn} bm={bm} warps={nw}: "
                  f"{type(e).__name__}: {str(e)[:200]}", flush=True)

    # ICP correspondence step (XLA) at the solver's refine width
    q = jnp.asarray(rng.normal(0, 0.05, (64, src.shape[0], 3)), jnp.float32)
    report("ICP nearest_neighbor [64 x N] XLA", timed(
        lambda: nearest_neighbor(q, tgt_d)), 64 * src.shape[0] * tgt.shape[0])

    # exact top_k normal estimate: compile + run at 10,654 points
    from goicp_tpu.geo.normals import estimate_normals

    pts = jnp.asarray(rng.normal(0, 0.05, (10654, 3)), jnp.float32)
    t0 = time.perf_counter()
    jax.block_until_ready(estimate_normals(pts, k=16))
    cold = time.perf_counter() - t0
    warm = timed(lambda: estimate_normals(pts, k=16), reps=3)
    rec["normals_10654"] = {"cold_s": cold, "warm_s": warm}
    print(f"estimate_normals 10654 pts (exact top_k): cold {cold:.2f} s, "
          f"warm {warm * 1e3:.1f} ms [{card}]", flush=True)

    if args.e2e:
        from goicp_tpu.bnb import BnbParams, make_solver

        _, _, src, tgt, R_gt, t_gt = cs.bunny()
        sse_opt = cs.optimum_sse(src, tgt, R_gt, t_gt)
        n = src.shape[0]
        rec["e2e"] = {}
        # kernels ("screen": fused singleton + grouped kernel) vs plain XLA
        # ("exact"); the chip_smoke phase-4 pair, ε and round width
        # turns: screen, exact, exact, screen (the first pass of each
        # backend compiles unless the persistent cache already holds it)
        for rep, b in enumerate(("screen", "exact", "exact", "screen")):
            p = BnbParams(mse_threshold=cs.CERT_FRACTION * sse_opt / n,
                          max_wall_s=args.budget, bound_backend=b,
                          se3_pop=cs.SE3_POP)
            res = make_solver(src, tgt, p).run()
            rec["e2e"].setdefault(b, []).append({
                "wall_s": res.wall_s, "nodes": res.rot_nodes,
                "rounds": res.rounds, "gap": res.gap,
                "converged": res.converged})
            print(f"e2e pass {rep} {b}: wall {res.wall_s:.2f} s nodes "
                  f"{res.rot_nodes} rounds {res.rounds} gap {res.gap:.4g} "
                  f"converged {res.converged} [{card}]", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
