"""Target-resident registration service — the production serving surface.

The reference binary registers exactly one (source, target) pair per process
launch (``src/main.cpp:14-33``: argv[1] TOML, one solve, exit).  Production
re-localization / scan-matching workloads answer MANY queries against one
resident model.  The serving design keeps everything expensive
resident and warm between queries:

- the **target cloud** and its **distance field** are built once
  (:class:`RegistrationService`; the per-solver reuse hook is
  ``make_solver(..., grid=...)``);
- **jit caches stay warm**: every query of an already-seen source size hits
  the compiled executable (plus the persistent compilation cache across
  process restarts);
- **micro-batching**: concurrent queries drain into ONE lockstep Go-ICP
  dispatch per BnB round (``multipair.register_pairs`` with the shared
  target) — P queries cost barely more wall than one.

Protocol: line-delimited JSON on stdio or TCP (``python -m goicp_tpu serve
target.ply --port 7345``).  With ``--auth-token`` (or ``$GOICP_AUTH_TOKEN``)
each TCP connection first sends ``{"auth": "<token>"}``; then one request
per line:

    {"id": 1, "source": "scan.ply", "subsample": 0.5}
    {"id": 2, "points": [[x, y, z], ...]}
    {"id": 3, "points": [...], "init": {"R": [[..]x3], "t": [..]}}
                                       # re-localization prior: pinned as a
                                       # multistart seed (still optimal)
    {"id": 4, "points": [...], "mode": "icp", "init": {...}}
                                       # tracking path: local ICP only
    {"id": 5, "points": [...], "mode": "icp", "init": {...},
     "escalate_mse": 1e-3}             # tracking with loss escalation: if
                                       # the refine lands above that mse the
                                       # query re-queues into the certified
                                       # goicp lane ("escalated": true)
    {"batch": [{...}, {...}]}          # explicit batch (icp-mode items share
                                       # one vmapped refine; goicp items one
                                       # lockstep BnB)
    {"cmd": "info"} | {"cmd": "shutdown"}

Response per request (same order; ``id`` echoed):

    {"id": 1, "ok": true, "R": [[...]x3], "t": [...], "mse": ..,
     "sse": .., "converged": true, "gap": .., "nodes": .., "wall_s": ..}

The implementation lives in the :mod:`goicp_tpu.serving` package (state /
protocol / tcp / cli split); this module is the stable public import path.
"""

from goicp_tpu.serving import (  # noqa: F401  (re-export surface)
    Batcher,
    MultiTargetService,
    RegistrationService,
    handle_request,
    main,
    serve_stdio,
    serve_tcp,
)
from goicp_tpu.serving.protocol import (  # noqa: F401  (test/tool hooks)
    _error_json,
    _load_query_source,
    _mode,
    _overrides,
    _parse_init,
    _result_json,
    _validate_keys,
)
from goicp_tpu.serving.service import _PARAM_KEYS, _QUERY_KEYS  # noqa: F401
from goicp_tpu.serving.tcp import _Pending  # noqa: F401

__all__ = [
    "Batcher",
    "MultiTargetService",
    "RegistrationService",
    "handle_request",
    "main",
    "serve_stdio",
    "serve_tcp",
]

if __name__ == "__main__":
    raise SystemExit(main())
