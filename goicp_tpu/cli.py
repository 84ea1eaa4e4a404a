"""Scenario runner — the app driver (≙ ``src/main.cpp``).

Usage (≙ ``./bin/cis5650_fgo_icp ../test/bunny.toml``, README.md:39):

    python -m goicp_tpu <scenario.toml> [--output DIR] [--metrics PATH]

Loads the TOML config, the two clouds, dispatches on ``params.mode``
(``src/common.h:7-11``), runs the solver, and writes the artifacts the
reference promised but never produced (``io.output`` result TOML and
``io.visualization`` PLY, ``src/common.cpp:48-49``).

Mode mapping (reference semantics → implementation here):

- 0 ``ICP_CPU``  / 1 ``ICP_GPU``: iterated ICP with exact brute-force NN
  (≙ ``icp_kernel.cu:48-217``) — one jitted solve, not one step per frame.
- 2 ``ICP_KDTREE_GPU``: ICP with O(1) distance-grid correspondences — the
  grid replaces the flattened k-d tree (``icp_kernel.cu:281-377``), which
  the reference itself found slower than dense lookups (README.md:103-106).
- 3 ``GOICP_CPU`` / 4 ``GOICP_GPU``: globally-optimal BnB.  Both map to the
  flat SE(3) product engine over the axis-angle π-cube by default
  (``jly_goicp.cpp:44-48`` parametrization — its exponential map gives the
  uniform uncertainty bound; fgoicp's quaternion cube (``common.h:40-60``)
  is available via ``[tpu] rotation_param = "quaternion"``).  Mode 3 pins
  axis-angle for strict jly parity; mode 4 honors the config.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from goicp_tpu.bnb import BnbParams, GoIcpResult, GoIcpSolver, make_solver
from goicp_tpu.core.cache import enable_persistent_cache
from goicp_tpu.core.config import Config, Mode
from goicp_tpu.core.logging import get_logger
from goicp_tpu.core.progress import ProgressBus, SolverState
from goicp_tpu.core.types import RigidTransform
from goicp_tpu.icp import (
    IcpParams,
    exact_correspondence,
    grid_correspondence,
    run_icp,
    run_icp_trace,
)
from goicp_tpu.io import load_cloud, write_result_toml
from goicp_tpu.nn.grid import build_distance_grid
from goicp_tpu.viz import TrajectoryRecorder, write_registration_ply


def bnb_params_from_config(cfg: Config) -> BnbParams:
    t = cfg.tpu
    return BnbParams(
        mse_threshold=cfg.mse_threshold,
        trim_fraction=cfg.effective_trim_fraction,
        rotation_param=(
            "axis_angle" if cfg.mode == Mode.GOICP_CPU else t.rotation_param
        ),
        lookup=t.lookup,
        grid_resolution=t.grid_resolution,
        grid_expand=t.grid_expand,
        rot_pop=t.rot_batch,
        engine=t.engine,
        bound_backend=t.bound_backend,
        grid_method=t.grid_method,
        conservative=t.conservative,
        checkpoint_path=t.checkpoint_path or None,
        checkpoint_every=t.checkpoint_every,
        mesh_cubes=t.mesh_cubes,
        mesh_points=t.mesh_points,
        # honor [params.rotation/translation].search_depth — the reference
        # parses these into its Config but never uses them (SURVEY §2 C2);
        # depth d ⇒ subdivision floor at root_span / 2^d
        min_rot_span=max(t.min_rot_span, 2.0 ** -cfg.rotation.search_depth),
        min_trans_span=max(
            t.min_trans_span,
            cfg.translation.span * 2.0 ** -cfg.translation.search_depth,
        ),
        se3_pop=t.se3_pop,
        trans_span=cfg.translation.span,
        trans_center=cfg.translation.center,
        icp_refine_factor=t.icp_refine_factor,
        icp_max_iter=t.icp_max_iter,
        icp_rel_tol=t.icp_rel_tol,
        icp_metric=t.icp_metric,
        normals_k=t.normals_k,
        max_wall_s=t.max_wall_s,
    )


def run_icp_mode(cfg: Config, src, tgt, bus: ProgressBus | None = None):
    """Modes 0/1/2: plain iterated ICP (per-frame loop ≙ one jitted solve).

    With a ``bus``, the traced runner records every iteration's pose+SSE
    and publishes them as :class:`SolverState` snapshots — the trajectory/
    replay artifacts the reference shows as its frame-per-iteration
    animation (``main.cpp:99-141``)."""
    import jax.numpy as jnp

    params = IcpParams(
        max_iter=cfg.tpu.icp_max_iter,
        rel_tol=min(cfg.tpu.icp_rel_tol, cfg.mse_threshold),
        trim_fraction=cfg.effective_trim_fraction,
        metric=cfg.tpu.icp_metric,
    )
    normals = None
    if cfg.tpu.icp_metric == "plane":
        from goicp_tpu.geo.normals import estimate_normals

        normals = estimate_normals(tgt, k=cfg.tpu.normals_k)
    if cfg.mode == Mode.ICP_KDTREE_GPU:
        grid = build_distance_grid(
            tgt, n=cfg.tpu.grid_resolution, method="edt", with_index=True
        )
        corr = grid_correspondence(grid, jnp.asarray(tgt), normals=normals)
    else:
        corr = exact_correspondence(tgt, normals=normals)
    t0 = time.perf_counter()
    if bus is not None:
        res, trace = run_icp_trace(src, corr, RigidTransform.identity(), params)
        wall = time.perf_counter() - t0
        R_tr, t_tr, sse_tr, act = (np.asarray(x) for x in trace)
        best = np.inf
        opt_R, opt_t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        for k in range(R_tr.shape[0]):
            if not act[k]:
                break
            if sse_tr[k] < best:
                best, opt_R, opt_t = float(sse_tr[k]), R_tr[k], t_tr[k]
            bus.publish(SolverState(
                opt_R=opt_R, opt_t=opt_t, cur_R=R_tr[k], cur_t=t_tr[k],
                best_sse=best, gap=0.0, finished=False,
                rot_nodes=0, trans_nodes=0, round=k,
            ))
    else:
        res = run_icp(src, corr, RigidTransform.identity(), params)
        wall = time.perf_counter() - t0
    sse = float(res.sse)
    n_eff = max(1, int(round(src.shape[0] * (1 - cfg.effective_trim_fraction))))
    return {
        "R": np.asarray(res.transform.R),
        "t": np.asarray(res.transform.t),
        "sse": sse,
        "mse": sse / n_eff,
        # ≙ main.cpp:125-135: the reference iterates ICP until the error
        # clears mse_threshold; stopping early (stall / max_iter) is NOT
        # success — converged means the threshold was actually reached
        "converged": sse / n_eff <= cfg.mse_threshold,
        "icp_iters": int(res.iters),
        "rot_nodes": 0,
        "trans_nodes": 0,
        "wall_s": wall,
        "metrics": {},
    }


def run_goicp_mode(cfg: Config, src, tgt, bus: ProgressBus):
    params = bnb_params_from_config(cfg)
    if cfg.tpu.full_cert:
        # [tpu] full_cert: certify the FULL cloud to ε by adaptive subset
        # refinement (docs/ALGORITHM.md "Full-cloud certificates")
        from goicp_tpu.bnb import register_full_cert

        res: GoIcpResult = register_full_cert(
            src, tgt, params, progress=bus,
            target_gap_mse=cfg.tpu.full_cert_mse or None,
        )
    else:
        solver = make_solver(src, tgt, params, progress=bus)
        res = solver.run()
    return {
        "R": np.asarray(res.transform.R),
        "t": np.asarray(res.transform.t),
        "sse": res.sse,
        "mse": res.mse,
        "converged": res.converged,
        "icp_iters": res.icp_iters,
        "rot_nodes": res.rot_nodes,
        "trans_nodes": res.trans_nodes,
        "wall_s": res.wall_s,
        "metrics": res.metrics.summary(),
        # full-cloud certificate fields (bound_points-capped solves only)
        "gap": res.gap,
        "sse_full": res.sse_full,
        "mse_full": res.mse_full,
        "gap_full": res.gap_full,
    }


def run_scenario(
    toml_path: str,
    output_dir: str | None = None,
    checkpoint: str | None = None,
) -> dict:
    """Full scenario: load → solve → artifacts.  Returns the result dict."""
    enable_persistent_cache()
    log = get_logger()
    # ≙ the reference's window title (FPS + GPU name, main.cpp:173-178)
    import jax

    dev = jax.devices()[0]
    log.info(
        "backend: %d x %s", len(jax.devices()),
        getattr(dev, "device_kind", dev.platform),
    )
    cfg = Config.from_toml(toml_path)
    if checkpoint:
        cfg.tpu.checkpoint_path = checkpoint
    seed = cfg.tpu.seed
    src = load_cloud(cfg.resolve(cfg.io.source), cfg.subsample, cfg.resize, seed)
    tgt = load_cloud(cfg.resolve(cfg.io.target), cfg.subsample, cfg.resize, seed)
    bus = ProgressBus()
    rec = TrajectoryRecorder(bus)
    outdir = output_dir or os.getcwd()
    if cfg.tpu.snapshot_every_s > 0:
        from goicp_tpu.viz import LiveSnapshotter

        LiveSnapshotter(
            bus,
            os.path.join(outdir, "snapshots"),
            tgt,
            src,
            every_s=cfg.tpu.snapshot_every_s,
            png=cfg.tpu.snapshot_png,
            html=cfg.tpu.snapshot_html,
        )

    t0 = time.perf_counter()
    if cfg.mode in (Mode.ICP_CPU, Mode.ICP_GPU, Mode.ICP_KDTREE_GPU):
        out = run_icp_mode(cfg, src, tgt, bus)
    else:
        out = run_goicp_mode(cfg, src, tgt, bus)
    out["total_wall_s"] = time.perf_counter() - t0
    out["scenario"] = os.path.basename(toml_path)
    out["n_src"], out["n_tgt"] = src.shape[0], tgt.shape[0]

    os.makedirs(outdir, exist_ok=True)
    result_path = os.path.join(outdir, os.path.basename(cfg.io.output) or "output.toml")
    viz_path = os.path.join(
        outdir, os.path.basename(cfg.io.visualization) or "viz.ply"
    )
    write_result_toml(
        result_path,
        out["R"],
        out["t"],
        out["mse"],
        out["sse"],
        mode=int(cfg.mode),
        converged=out["converged"],
        rot_nodes=out["rot_nodes"],
        trans_nodes=out["trans_nodes"],
        icp_iters=out["icp_iters"],
        wall_s=out["wall_s"],
        extra={
            "scenario": out["scenario"], "n_src": out["n_src"],
            "n_tgt": out["n_tgt"],
            # full-cloud certificate (present only when the BnB solved a
            # bound_points subset — see GoIcpResult field docs)
            **{
                k: out[k]
                for k in ("gap", "sse_full", "mse_full", "gap_full")
                if out.get(k) is not None
            },
        },
    )
    write_registration_ply(viz_path, tgt, src, out["R"], out["t"])
    try:
        from goicp_tpu.viz import render_png

        render_png(
            os.path.splitext(viz_path)[0] + ".png",
            tgt, src, out["R"], out["t"],
            phi=cfg.viz.phi, theta=cfg.viz.theta,
        )
    except Exception:  # matplotlib optional
        pass
    if rec.states:
        rec.dump_csv(os.path.join(outdir, "trajectory.csv"))
        from goicp_tpu.viz import render_html

        # interactive replay of the solve (incumbent red / explored white /
        # model blue) — the headless form of watching the reference's window
        render_html(
            os.path.splitext(viz_path)[0] + ".html", tgt, src, rec.states,
            phi=cfg.viz.phi or 0.35,
            theta=cfg.viz.theta or 0.6,
            spin=cfg.viz.spin_after_finish,
        )
    if out["metrics"]:
        import json

        with open(os.path.join(outdir, "metrics.json"), "w") as f:
            json.dump(out["metrics"], f, indent=2, sort_keys=True, default=float)
            f.write("\n")
    log.info(
        "Scenario %s: mode=%d mse=%.6g converged=%s wall=%.2fs → %s",
        out["scenario"],
        int(cfg.mode),
        out["mse"],
        out["converged"],
        out["wall_s"],
        result_path,
    )
    out["output_toml"] = result_path
    out["viz_ply"] = viz_path
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="goicp_tpu", description="globally-optimal (Go-)ICP registration"
    )
    ap.add_argument("config", help="scenario TOML (reference-compatible schema)")
    ap.add_argument("--output", default=None, help="artifact directory (default: cwd)")
    ap.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler trace of the solve into DIR",
    )
    ap.add_argument(
        "--checkpoint",
        default=None,
        metavar="PATH",
        help="BnB frontier snapshot file: written every [tpu].checkpoint_every "
        "rounds and resumed from if it exists (restart-based recovery)",
    )
    args = ap.parse_args(argv)
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
    out = run_scenario(args.config, args.output, checkpoint=args.checkpoint)
    if args.profile:
        import jax

        jax.profiler.stop_trace()
    print(
        f"mode={out['scenario']} mse={out['mse']:.6g} sse={out['sse']:.6g} "
        f"converged={out['converged']} wall={out['wall_s']:.2f}s"
    )
    return 0 if out["converged"] else 1


if __name__ == "__main__":
    sys.exit(main())
