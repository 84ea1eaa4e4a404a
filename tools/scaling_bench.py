"""Strong-scaling measurement of the sharded SE(3) bound round.

Runs the multi-chip round (``dist.se3.make_sharded_se3_round``) at mesh
shapes 1/2/4/8 over the ``cubes`` axis on a virtual CPU device mesh
(``--xla_force_host_platform_device_count``, SURVEY §4) and reports node
throughput + parallel efficiency.

Methodology note for the record: ``shard_map`` partitions *manually* — each
device executes the bound kernel on exactly ``M / n_cubes`` nodes, and the
only cross-device traffic is the per-round incumbent top-k over ``[M]``
scalars (plus ``[M]``-scalar psums when the point axis is sharded).  On this
host the virtual devices share ``nproc`` physical cores and XLA's 1-device
CPU baseline is itself partially multi-threaded, so measured efficiency is a
LOWER bound on mesh scaling: past n_devices ≈ cores the curve is core-bound,
not communication-bound.  On real accelerators the collectives ride the
interconnect and the per-device compute is the measured single-chip rate.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/scaling_bench.py [--out docs/scaling_r02.json]
"""

import argparse
import json
import os
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/scaling_r02.json")
    ap.add_argument("--jobs", type=int, default=2048)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--targets", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from goicp_tpu.dist.se3 import make_sharded_se3_round, pad_points
    from goicp_tpu.dist.sharding import make_mesh
    from goicp_tpu.icp import IcpParams
    from goicp_tpu.nn.grid import build_distance_grid

    n_dev = len(jax.devices())
    rng = np.random.default_rng(0)
    N, Nt, M = args.points, args.targets, args.jobs
    src = (rng.random((N, 3)).astype(np.float32) - 0.5)
    tgt = (rng.random((Nt, 3)).astype(np.float32) - 0.5)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    grid = build_distance_grid(
        tgt, n=8, cover=np.array([[1.5] * 3, [-1.5] * 3]), method="brute",
        with_index=True,
    )
    Rm = np.tile(np.eye(3, dtype=np.float32), (M, 1, 1))
    ang = rng.random(M).astype(np.float32) * 0.4
    t_c = (rng.random((M, 3)).astype(np.float32) - 0.5) * 0.3
    t_s = rng.random(M).astype(np.float32) * 0.1
    mask = np.ones(M, bool)

    rows = []
    sizes = [s for s in (1, 2, 4, 8, 16) if s <= n_dev]
    for n_c in sizes:
        mesh = make_mesh(n_c, 1)
        sp, npd = pad_points(src, norms, 1, 128)
        rnd = make_sharded_se3_round(
            mesh, h=0, n_valid=N, lookup="nearest", backend="exact",
            tile=128, refine_k=4, icp_params=IcpParams(max_iter=1),
            icp_backend="exact",
        )
        call_args = (
            jnp.asarray(sp), jnp.asarray(npd), grid, jnp.asarray(tgt),
            jnp.float32(0), jnp.float32(np.inf), jnp.asarray(Rm),
            jnp.asarray(ang), jnp.asarray(t_c), jnp.asarray(t_s),
            jnp.asarray(mask), jnp.asarray(src),
        )
        out = rnd(*call_args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = rnd(*call_args)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.reps
        rows.append({"devices": n_c, "round_s": dt, "nodes_per_s": M / dt})
        print(f"devices={n_c}: {dt*1e3:.0f} ms/round, {M/dt:,.0f} nodes/s")

    base = rows[0]["nodes_per_s"]
    for r in rows[1:]:
        r["speedup"] = r["nodes_per_s"] / base
        r["efficiency"] = r["speedup"] / r["devices"]
        print(
            f"devices={r['devices']}: speedup {r['speedup']:.2f}x, "
            f"efficiency {r['efficiency']*100:.0f}%"
        )

    result = {
        "workload": {"jobs": M, "points": N, "targets": Nt,
                     "backend": "exact"},
        "host_cores": os.cpu_count(),
        "virtual_devices": n_dev,
        "rows": rows,
        "note": (
            "virtual CPU devices share the physical cores; efficiency is a "
            "lower bound (the 1-device XLA CPU baseline is itself "
            "multi-threaded). shard_map partitions per-device work exactly "
            "M/n_devices; cross-device traffic is [M] scalars per round."
        ),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
