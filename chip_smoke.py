#!/usr/bin/env python3
"""GPU smoke test: drive goicp_tpu's main paths once on the card and check
what comes out.

    python chip_smoke.py               # one GPU: phases 1-6 below
    python chip_smoke.py --four-cards  # four GPUs of one host: mesh path only

Everything runs in this one process (one process per card).  Phases:

1. device — a GPU must be the default JAX device (there is no CPU
   fallback); prints the card (``nvidia-smi`` name and power limit), the
   device kind, whether the native frontier library loaded, and the
   compile-cache directory.
2. kernels — each fused Pallas kernel, compiled for the card, against the
   plain XLA brute force at bunny@0.05 widths (N = 1518 sources,
   Nt = 1797 targets, neither a multiple of a block), B = 2048 nodes, plus
   a float64 numpy oracle on a subset; the XLA ``exact`` bound path
   against its certified f32 slack; and a check that HIGHEST-precision
   matmuls run in full f32, not TF32.
3. cli — ``goicp_tpu.cli.run_scenario`` (the entry behind
   ``python -m goicp_tpu``) on the in-repo bunny fixture.
4. certified solve — ``make_solver`` on a noisy bunny pair with the
   backend ``auto`` picks on the GPU and an ε below the optimum's SSE, so
   only the gap rule can certify: the BnB must expand ≥ 10⁴ nodes and
   close the gap inside its wall budget.
5. lockstep — ``register_pairs`` on 4 seeded poses against the solo solves.
6. serving — an in-process ``RegistrationService`` answering goicp and
   icp-tracking queries.

Any failed phase raises, so the script exits non-zero and prints no
result.  The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EPS_F32 = 1.2e-7        # the solver's f32 error model (bnb.solver)
RTOL = 1e-5             # kernel parity: relative, f32 elementwise, HIGHEST
N_SRC, N_TGT, N_NODES = 1518, 1797, 2048
SIGMA = 0.001           # source noise of the certified-solve pair (m)
CERT_FRACTION = 0.75    # phase 4: ε = this × the optimum's SSE
PAIRS_FRACTION = 0.9    # phases 5/6 and the mesh: ε = this × optimum SSE
SE3_POP = 512           # nodes popped per round: 2 job buckets to compile
MAX_WALL_S = 120.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rot_angle(Ra, Rb) -> float:
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64))
         - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def phase(name):
    def wrap(fn):
        def run(*a, **k):
            log(f"== phase {name}")
            t0 = time.perf_counter()
            out = fn(*a, **k)
            log(f"== phase {name}: ok ({time.perf_counter() - t0:.2f} s)")
            return out
        return run
    return wrap


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


def bunny():
    """The in-repo bunny pair: bun000 (recovered from the fixture's GT) and
    its rigidly moved copy, both at subsample 0.05 with different seeds,
    the source with σ-noise — plus the GT pose."""
    from goicp_tpu.io.generated import load_pair
    from goicp_tpu.io.loader import subsample_cloud

    src_full, tgt_full, R, t = load_pair("rotated_bunny")
    src = subsample_cloud(src_full, 0.05, seed=1)
    tgt = subsample_cloud(tgt_full, 0.05, seed=0)
    rng = np.random.default_rng(11)
    src = (src + rng.normal(0.0, SIGMA, src.shape)).astype(np.float32)
    return src_full, tgt_full, src, tgt, R, t


def optimum_sse(src, tgt, R, t) -> float:
    """SSE of the pair at the ICP-polished GT pose (the calibration run
    that places ε below the optimum)."""
    import jax.numpy as jnp

    from goicp_tpu.core.types import RigidTransform
    from goicp_tpu.icp import IcpParams, exact_correspondence, run_icp

    res = run_icp(
        jnp.asarray(src), exact_correspondence(tgt),
        RigidTransform(jnp.asarray(R)[None], jnp.asarray(t)[None]),
        IcpParams(max_iter=100, rel_tol=1e-6),
    )
    return float(np.asarray(res.sse)[0])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


@phase("1 device")
def phase_device(count: int):
    import jax

    from goicp_tpu import _native
    from goicp_tpu.core.cache import cache_dir

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"default JAX device is {devs[0].platform!r}, not a GPU")
    check(len(devs) >= count, f"{len(devs)} GPU(s) visible, need {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")
    log(f"device_kind: {devs[0].device_kind} x {len(devs)}")
    log(f"native frontier library loaded: {_native.lib() is not None}")
    log(f"compile cache: {cache_dir()}")
    return devs


@phase("2 kernels")
def phase_kernels(src, tgt):
    import jax
    import jax.numpy as jnp

    from goicp_tpu.bnb.device_inner import _exact_min_d2
    from goicp_tpu.core.device import kernel_route
    from goicp_tpu.geo.rotation import random_rotations
    from goicp_tpu.nn import mxu
    from goicp_tpu.nn.brute import min_dist_sq

    check(kernel_route() == "triton", f"kernel route {kernel_route()!r}")
    src, tgt = src[:N_SRC], tgt[:N_TGT]
    rng = np.random.default_rng(7)
    B = N_NODES
    R = random_rotations(B, rng).astype(np.float32)
    t = (tgt.mean(0) - np.einsum("bij,j->bi", R, src.mean(0))
         + rng.uniform(-0.05, 0.05, (B, 3))).astype(np.float32)
    af = rng.uniform(0.0, 0.3, B).astype(np.float32)
    gt = rng.uniform(0.0, 0.05, B).astype(np.float32)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    scale = float(np.abs(src).max() + np.abs(tgt).max())
    atol_d2 = 8.0 * EPS_F32 * scale**2      # f32 cancellation model

    # matmul precision: HIGHEST must be full f32 on the card, never TF32
    a = rng.normal(size=(4096, 3)).astype(np.float32)
    prod = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(a).T,
                              precision=jax.lax.Precision.HIGHEST))
    ref = a.astype(np.float64) @ a.T.astype(np.float64)
    mm_err = float(np.abs(prod - ref).max() / np.abs(ref).max())
    log(f"HIGHEST f32 matmul max rel error {mm_err:.3g} (TF32 ≈ 1e-3)")
    check(mm_err < 1e-6, "HIGHEST-precision matmul is not full f32")

    # reference: XLA elementwise brute force (f32) → float64 epilogue
    pts = jnp.einsum("bij,nj->bni", jnp.asarray(R), jnp.asarray(src),
                     precision=jax.lax.Precision.HIGHEST) + t[:, None, :]
    d2_ref = np.asarray(min_dist_sq(pts, jnp.asarray(tgt)), np.float64)

    def bounds_from(d2, slack=0.0):
        d = np.sqrt(np.maximum(d2, 0.0))
        lo = np.maximum(np.maximum(d - slack, 0.0)
                        - (af[:, None] * norms + gt[:, None]), 0.0)
        return ((d + slack) ** 2).sum(-1), (lo ** 2).sum(-1)

    ub_ref, lb_ref = bounds_from(d2_ref)

    # float64 oracle on 16 nodes: validates the XLA reference itself
    sub = np.arange(0, B, B // 16)
    q64 = (np.einsum("bij,nj->bni", R[sub].astype(np.float64), src)
           + t[sub, None, :])
    d2_64 = np.stack([
        ((q[:, None, :] - tgt[None].astype(np.float64)) ** 2).sum(-1).min(-1)
        for q in q64
    ])
    err = np.abs(d2_ref[sub] - d2_64)
    check((err <= RTOL * d2_64 + atol_d2).all(),
          f"XLA brute d² off the float64 oracle by {err.max():.3g}")
    log(f"XLA brute vs float64 oracle: max |Δd²| {err.max():.3g} "
        f"(tolerance {RTOL:g}·d² + {atol_d2:.3g})")

    # bound sums: relative RTOL, plus the f32 model summed over the N
    # terms (a term near the deflation radius carries d's rounding, so a
    # node whose lb is a few tiny terms has no relative precision)
    atol_sum = N_SRC * atol_d2

    def off(x, r):
        """Largest error of ``x`` against ``r`` in units of the tolerance
        (≤ 1 passes), and the largest relative error for the log."""
        x, r = np.asarray(x, np.float64), np.asarray(r, np.float64)
        err = np.abs(x - r)
        return (float((err / (RTOL * np.abs(r) + atol_sum)).max()),
                float((err / np.maximum(np.abs(r), 1e-30)).max()))

    # (a) fused bounds, screening off
    params = mxu.pack_params_bounds(R, t, af, gt, 0.0, 1e30)
    ub, lb = jax.device_get(mxu.bounds_nodes(src, norms, tgt, params))
    (k_ub, e_ub), (k_lb, e_lb) = off(ub, ub_ref), off(lb, lb_ref)
    log(f"bounds_nodes vs XLA brute: max rel error ub {e_ub:.3g} lb "
        f"{e_lb:.3g}; max error / tolerance ({RTOL:g}·x + {atol_sum:.3g}) "
        f"{max(k_ub, k_lb):.3g}")
    check(max(k_ub, k_lb) <= 1.0, "bounds_nodes off the XLA reference")
    d64 = np.sqrt(d2_64)
    ub64 = (d64 ** 2).sum(-1)
    lb64 = (np.maximum(d64 - (af[sub, None] * norms + gt[sub, None]), 0.0)
            ** 2).sum(-1)
    (k1, e1), (k2, e2) = off(ub[sub], ub64), off(lb[sub], lb64)
    e64 = max(e1, e2)
    log(f"bounds_nodes vs float64 oracle (16 nodes): max rel error ub "
        f"{e1:.3g} lb {e2:.3g}; max error / tolerance {max(k1, k2):.3g}")
    check(max(k1, k2) <= 1.0, "bounds_nodes off the float64 oracle")

    # (c) per-point kernel (the unfused "mxu" path)
    d2n = np.asarray(mxu.min_d2_nodes(src, tgt, R, t), np.float64)
    errn = np.abs(d2n[:, :N_SRC] - d2_ref)
    log(f"min_d2_nodes vs XLA brute: max |Δd²| {errn.max():.3g}")
    check((errn <= RTOL * d2_ref + atol_d2).all(),
          "min_d2_nodes off the XLA reference")

    # (a) screened: partial lbs stay valid lower bounds
    thresh = float(np.median(lb_ref))
    params = mxu.pack_params_bounds(R, t, af, gt, 0.0, thresh)
    ub_s, lb_s = (np.asarray(x, np.float64) for x in jax.device_get(
        mxu.bounds_nodes(src, norms, tgt, params)))
    scr = ub_s >= 1e29
    tol = RTOL * np.abs(lb_ref) + atol_sum
    check(scr.sum() > 0 and (~scr).sum() > 0, "screen never/always fired")
    check((lb_s[scr] <= lb_ref[scr] + tol[scr]).all(),
          "a screened lb exceeds the full lb")
    check((lb_s[scr] >= thresh * (1 - RTOL)).all(),
          "a screened lb is below the threshold")
    check(off(ub_s[~scr], ub_ref[~scr])[0] <= 1.0, "unscreened ub mismatch")
    log(f"bounds_nodes screened: {int(scr.sum())}/{B} nodes stopped early; "
        f"max (screened lb − full lb)/lb "
        f"{float(((lb_s[scr] - lb_ref[scr]) / lb_ref[scr]).max()):.3g}")

    # (b) grouped kernel: 256 groups × 8 translation siblings
    G = B // 8
    Rg = R[::8]
    t8 = (t[::8, None, :] + rng.uniform(-0.02, 0.02, (G, 8, 3))).astype(
        np.float32)
    d2g = np.asarray(mxu.min_d2_groups(src, tgt,
                                       mxu.pack_group_params(Rg, t8)))
    ptsg = jnp.einsum("bij,nj->bni", jnp.asarray(np.repeat(Rg, 8, 0)),
                      jnp.asarray(src),
                      precision=jax.lax.Precision.HIGHEST) \
        + t8.reshape(-1, 3)[:, None, :]
    d2g_ref = np.asarray(min_dist_sq(ptsg, jnp.asarray(tgt)), np.float64)
    errg = np.abs(d2g[:, :N_SRC] - d2g_ref)
    log(f"min_d2_groups vs XLA brute: max |Δd²| {errg.max():.3g}, max rel "
        f"{float((errg / np.maximum(d2g_ref, 1e-30)).max()):.3g} "
        f"(tolerance {RTOL:g}·d² + {atol_d2:.3g})")
    check((errg <= RTOL * d2g_ref + atol_d2).all(),
          "min_d2_groups off the XLA reference")

    # XLA exact bound path (|q|² − 2q·m + |m|², cuBLAS): inside its slack
    slack = float(np.sqrt(8.0 * EPS_F32) * (scale + 0.5 * np.sqrt(3.0)))
    tiles = jnp.asarray(np.concatenate(
        [tgt, np.full(((-N_TGT) % 256, 3), 1e15, np.float32)]
    ).reshape(-1, 256, 3))
    d2x = np.asarray(_exact_min_d2(
        jnp.asarray(q64, jnp.float32), tiles, jnp.sum(tiles * tiles, -1)
    ), np.float64)
    dev = float(np.abs(np.sqrt(d2x) - np.sqrt(d2_64)).max())
    log(f"XLA exact path: max |Δd| {dev:.3g} vs certified slack {slack:.3g}")
    check(dev <= slack, "XLA exact path outside its certified slack")
    return {"mm_err": mm_err, "bounds_rel": max(e_ub, e_lb, e64),
            "nodes_abs": float(errn.max()), "groups_abs": float(errg.max()),
            "exact_dev": dev}


@phase("3 cli")
def phase_cli(src_full, R, t):
    import tomllib

    from goicp_tpu.cli import run_scenario
    from goicp_tpu.io import write_ply
    from goicp_tpu.io.generated import DATA_DIR

    with tempfile.TemporaryDirectory() as tmp:
        write_ply(os.path.join(tmp, "bun000.ply"), src_full)
        toml = os.path.join(tmp, "bunny.toml")
        with open(toml, "w") as f:
            f.write(
                "[io]\n"
                f'target = "{DATA_DIR / "rotated_bunny.ply"}"\n'
                'source = "bun000.ply"\n'
                'output = "output.toml"\n'
                'visualization = "viz.ply"\n'
                "[params]\nmode = 4\nsubsample = 0.05\n"
                "mse_threshold = 1e-5\n"
            )
        out = run_scenario(toml, os.path.join(tmp, "out"))
        ang, dt = rot_angle(out["R"], R), float(np.abs(out["t"] - t).max())
        log(f"cli: converged={out['converged']} mse={out['mse']:.3g} "
            f"pose error {ang:.3g} rad / {dt:.3g} m, "
            f"wall {out['wall_s']:.2f} s, total {out['total_wall_s']:.2f} s")
        check(out["converged"], "cli solve did not converge")
        check(ang < 1e-3 and dt < 1e-3, "cli pose off the GT")
        with open(out["output_toml"], "rb") as f:
            doc = tomllib.load(f)
        check("rotation" in doc or "R" in doc or len(doc) > 0,
              "output.toml is empty")
        log(f"cli: wrote {os.path.basename(out['output_toml'])} "
            f"({len(doc)} keys)")


@phase("4 certified solve")
def phase_certified(src, tgt, R, t, sse_opt):
    from goicp_tpu.bnb import BnbParams, make_solver

    n = src.shape[0]
    p = BnbParams(mse_threshold=CERT_FRACTION * sse_opt / n,
                  max_wall_s=MAX_WALL_S, se3_pop=SE3_POP)
    walls = []
    for _ in range(2):                       # cold, then warm
        solver = make_solver(src, tgt, p)
        res = solver.run()
        walls.append(res.wall_s)
    eps = p.mse_threshold * n
    ang, dt = rot_angle(res.transform.R, R), float(
        np.abs(res.transform.t - t).max())
    log(f"certified: backend={solver._backend} nodes={res.rot_nodes} "
        f"rounds={res.rounds} wall cold {walls[0]:.2f} s warm "
        f"{walls[1]:.2f} s gap={res.gap:.4g} ε={eps:.4g} "
        f"sse={res.sse:.4g} (optimum ≈ {sse_opt:.4g}) pose error "
        f"{ang:.3g} rad / {dt:.3g} m")
    check(solver._backend == "screen", f"auto chose {solver._backend!r}")
    check(res.sse > eps, "ε-rule could fire: ε above the incumbent")
    check(res.rot_nodes >= 10_000, "BnB did not engage (< 1e4 nodes)")
    check(res.converged and res.gap <= eps, "BnB did not close the gap")
    check(ang < 0.02 and dt < 5e-3, "certified pose off the GT")
    return res


def _posed_sources(src, R, t, k):
    """``k`` seeded rotations of the source; GT of pair j is
    ``(R·Q_jᵀ, t)``."""
    from goicp_tpu.geo.rotation import random_rotations

    Q = random_rotations(k, np.random.default_rng(21)).astype(np.float32)
    return ([(src @ q.T).astype(np.float32) for q in Q],
            [(R @ q.T, t) for q in Q])


@phase("5 lockstep")
def phase_lockstep(src, tgt, R, t, sse_opt):
    from goicp_tpu.bnb import BnbParams, make_solver
    from goicp_tpu.multipair import register_pairs

    srcs, gts = _posed_sources(src, R, t, 4)
    p = BnbParams(mse_threshold=PAIRS_FRACTION * sse_opt / src.shape[0],
                  max_wall_s=MAX_WALL_S, se3_pop=SE3_POP)
    t0 = time.perf_counter()
    batch = register_pairs([(s, tgt) for s in srcs], p)
    wall = time.perf_counter() - t0
    for j, (res, s) in enumerate(zip(batch, srcs)):
        solo = make_solver(s, tgt, p).run()
        ang = rot_angle(res.transform.R, solo.transform.R)
        ang_gt = rot_angle(res.transform.R, gts[j][0])
        log(f"lockstep pair {j}: converged={res.converged} "
            f"nodes={res.rot_nodes} sse={res.sse:.4g} solo sse="
            f"{solo.sse:.4g} Δpose {ang:.3g} rad, vs GT {ang_gt:.3g} rad")
        check(res.converged and solo.converged, f"pair {j} not converged")
        eps = p.mse_threshold * s.shape[0]
        check(abs(res.sse - solo.sse) <= eps, f"pair {j} sse ≠ solo")
        check(ang < 0.02 and ang_gt < 0.02, f"pair {j} pose ≠ solo/GT")
    log(f"lockstep: 4 pairs in {wall:.2f} s")


@phase("6 serving")
def phase_serving(src, tgt, R, t, sse_opt):
    from goicp_tpu.bnb import BnbParams
    from goicp_tpu.core.types import RigidTransform
    from goicp_tpu.geo.rotation import axis_angle_rotation
    from goicp_tpu.serving.service import RegistrationService

    srcs, gts = _posed_sources(src, R, t, 3)
    svc = RegistrationService(
        tgt, BnbParams(mse_threshold=PAIRS_FRACTION * sse_opt / src.shape[0],
                       max_wall_s=MAX_WALL_S, se3_pop=SE3_POP))
    for j, s in enumerate(srcs):
        t0 = time.perf_counter()
        res = svc.register(s)
        ang = rot_angle(res.transform.R, gts[j][0])
        dt = float(np.abs(res.transform.t - gts[j][1]).max())
        log(f"serving goicp query {j}: converged={res.converged} "
            f"{time.perf_counter() - t0:.2f} s, pose error {ang:.3g} rad / "
            f"{dt:.3g} m")
        check(res.converged and ang < 0.02 and dt < 5e-3,
              f"goicp query {j} off the GT")
    rng = np.random.default_rng(5)
    for j, s in enumerate(srcs):
        Rg, tg = gts[j]
        dR = np.asarray(axis_angle_rotation(rng.normal(0, 0.02, 3)))
        init = RigidTransform((dR @ Rg).astype(np.float32),
                              (tg + rng.normal(0, 0.003, 3)).astype(
                                  np.float32))
        t0 = time.perf_counter()
        res = svc.refine(s, init=init)
        ang = rot_angle(res.transform.R, Rg)
        dt = float(np.abs(res.transform.t - tg).max())
        log(f"serving icp query {j}: {time.perf_counter() - t0:.3f} s, "
            f"mse {res.mse:.3g}, pose error {ang:.3g} rad / {dt:.3g} m")
        check(ang < 0.02 and dt < 5e-3, f"icp query {j} off the GT")


@phase("mesh (4 cards)")
def phase_four_cards(src, tgt, R, t, sse_opt):
    import jax
    import jax.numpy as jnp

    from goicp_tpu.bnb import BnbParams, make_solver
    from goicp_tpu.dist.se3 import make_engine_mesh

    n = src.shape[0]
    base = BnbParams(mse_threshold=PAIRS_FRACTION * sse_opt / n,
                     max_wall_s=MAX_WALL_S, se3_pop=SE3_POP, mesh_cubes=1)
    eps = base.mse_threshold * n
    one = make_solver(src, tgt, base).run()
    log(f"1 card: nodes={one.rot_nodes} wall {one.wall_s:.2f} s "
        f"sse={one.sse:.4g} gap={one.gap:.4g}")
    check(one.converged and one.gap <= eps, "1-card solve did not certify")
    for cubes, points in ((4, 1), (2, 2)):
        import dataclasses

        p = dataclasses.replace(base, mesh_cubes=cubes, mesh_points=points)
        solver = make_solver(src, tgt, p)
        # the sharded round must spread its work over all 4 devices
        fn, src_pad, norms_pad, n_c, n_p = make_engine_mesh(
            p, solver._backend, solver.src, np.asarray(solver.ev.norms),
            h=0, icp_params=solver._icp_params_round_mesh,
            icp_backend=solver._icp_backend,
        )
        M = 8 * SE3_POP          # the solver's round width (one compile)
        rng = np.random.default_rng(3)
        from goicp_tpu.geo.rotation import random_rotations

        Rj = jnp.asarray(random_rotations(M, rng), jnp.float32)
        ub, *_ = fn(
            src_pad, norms_pad, solver.grid, solver._tgt_dev,
            jnp.float32(0.0), jnp.float32(np.inf), Rj,
            jnp.asarray(np.full(M, 0.1, np.float32)),
            jnp.asarray(rng.uniform(-0.05, 0.05, (M, 3)), jnp.float32),
            jnp.asarray(np.full(M, 0.01, np.float32)),
            jnp.asarray(np.ones(M, bool)),
            solver._src_dev, jnp.float32(np.inf),
        )
        ub.block_until_ready()
        devs = ub.sharding.device_set
        log(f"{cubes}x{points} mesh: backend={solver._backend} round "
            f"output spans {len(devs)} devices")
        check(len(devs) == 4, f"sharded round on {len(devs)} device(s)")
        res = solver.run()
        ang = rot_angle(res.transform.R, one.transform.R)
        log(f"{cubes}x{points} mesh: nodes={res.rot_nodes} wall "
            f"{res.wall_s:.2f} s sse={res.sse:.4g} gap={res.gap:.4g} "
            f"Δpose vs 1 card {ang:.3g} rad")
        check(res.converged and res.gap <= eps, f"{cubes}x{points} gap > ε")
        check(abs(res.sse - one.sse) <= eps and ang < 0.02,
              f"{cubes}x{points} mesh disagrees with the 1-card solve")
    return jax.devices()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its 1-card "
                         "comparison")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "goicp_tpu")):
        print("chip_smoke.py must run from a goicp_tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from goicp_tpu.core.cache import enable_persistent_cache

    enable_persistent_cache()
    devs = phase_device(4 if args.four_cards else 1)
    src_full, _, src, tgt, R, t = bunny()
    sse_opt = optimum_sse(src, tgt, R, t)
    log(f"pair: {src.shape[0]} source / {tgt.shape[0]} target points, "
        f"σ={SIGMA}, optimum sse ≈ {sse_opt:.4g}")
    if args.four_cards:
        devs = phase_four_cards(src, tgt, R, t, sse_opt)
    else:
        phase_kernels(src, tgt)
        phase_cli(src_full, R, t)
        phase_certified(src, tgt, R, t, sse_opt)
        phase_lockstep(src, tgt, R, t, sse_opt)
        phase_serving(src, tgt, R, t, sse_opt)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
