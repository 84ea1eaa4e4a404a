"""Multi-HOST BnB throughput scaling (BASELINE north-star: >=70% at 2+ hosts).

Protocol (fair on a shared-core box): every process is pinned to the SAME
number of physical cores with ``taskset``, so "1 host" vs "2 hosts" compares
equal per-host compute and the ratio isolates the protocol overhead
(lockstep allgathers, rebalancing, root-partition skew) — the quantity that
carries to real pods, where each host has its own chips.

    efficiency(P) = total_nodes_per_s(P) / (P * nodes_per_s(1))

Runs the discovery-shaped Gloo problem from tests/multihost_worker.py
(identity-start, so the BnB performs real distributed search).  Writes
docs/multihost_scaling.json.

Usage: python tools/multihost_scaling.py [cores_per_proc=2]
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(nproc: int, cores_per: int, hard: bool, max_rounds: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"      # CPU Gloo workers: no accelerator
    if hard:
        env["GOICP_MH_HARD"] = "1"
    port = free_port()
    procs, outs = [], []
    t0 = time.perf_counter()
    for pid in range(nproc):
        out = f"/tmp/mhscale_{int(hard)}_{nproc}_{pid}.json"
        outs.append(out)
        lo = pid * cores_per
        cmd = [
            "taskset", "-c", f"{lo}-{lo + cores_per - 1}",
            sys.executable, WORKER, str(pid), str(nproc), str(port), out,
            "1", "", str(max_rounds),
        ]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        ))
    for pr in procs:
        assert pr.wait(timeout=900) == 0
    wall = time.perf_counter() - t0
    recs = [json.load(open(o)) for o in outs]
    total_nodes = sum(r["local_nodes"] for r in recs)
    # solver-only wall (max over lockstep processes) excludes the
    # per-process jax/XLA startup + first-compiles, which dominate these
    # small problems but amortize to nothing on real pod solves
    solver_wall = max(r["solver_wall_s"] for r in recs)
    if not hard:
        assert all(r["converged"] for r in recs)
    return {
        "processes": nproc,
        "cores_per_process": cores_per,
        "wall_s": round(wall, 2),
        "solver_wall_s": round(solver_wall, 2),
        "time_to_solution_speedup": None,   # filled by main()
        "total_nodes": total_nodes,
        "nodes_per_s": round(total_nodes / solver_wall, 1),
        "node_split": [r["local_nodes"] for r in recs],
        "rebalances": recs[0].get("rebalances", 0),
    }


def sweep(hard: bool, cores_per: int, max_rounds: int, ncores: int) -> list:
    rows = [run(1, cores_per, hard, max_rounds)]
    p = 2
    while p * cores_per <= ncores:
        rows.append(run(p, cores_per, hard, max_rounds))
        p *= 2
    base = rows[0]["nodes_per_s"]
    base_tts = rows[0]["solver_wall_s"]
    rows[0].pop("time_to_solution_speedup")
    for r in rows[1:]:
        r["speedup"] = round(r["nodes_per_s"] / base, 2)
        r["efficiency"] = round(r["speedup"] / r["processes"], 2)
        r["time_to_solution_speedup"] = round(
            base_tts / r["solver_wall_s"], 2
        )
    for row in rows:
        print(("hard " if hard else "disc "), row)
    return rows


def main():
    cores_per = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    ncores = os.cpu_count() or 1
    result = {
        "workloads": {
            "discovery": {
                "what": "150-pt noise-free pair, identity start, solve to "
                        "convergence — tiny rounds, protocol-latency-bound "
                        "(worst case for the lockstep)",
                "rows": sweep(False, cores_per, 600, ncores),
            },
            "certification_fixed_rounds": {
                "what": "150-pt noisy pair, thresh below optimal mse, "
                        "FIXED 300 lockstep rounds — full-width balanced "
                        "rounds, the regime of the real headline solve "
                        "(~95% certification)",
                "rows": sweep(True, cores_per, 300, ncores),
            },
        },
        "host_cores": ncores,
        "note": (
            "every process pinned to its own equal core set (taskset), so "
            "ratios measure the multihost protocol (lockstep allgather "
            "cadence, root-partition skew, rebalancing), not core "
            "contention. solver_wall_s excludes jax/XLA startup/compiles "
            "(they amortize on real pods). nodes = BnB nodes actually "
            "evaluated; a distributed solve may evaluate a different "
            "total (pruning-order effects), so efficiency uses total "
            "nodes/s. CPU Gloo allgather latency is orders of magnitude "
            "above an accelerator interconnect's — these are LOWER bounds "
            "for an accelerator cluster's efficiency."
        ),
    }
    out = os.path.join(REPO, "docs", "multihost_scaling.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
