"""Optimality cross-check: the device solver vs the independent numpy BnB oracle
(SURVEY §4: "optimality tests vs the CPU jly algorithm as oracle")."""

import numpy as np
import pytest

from goicp_tpu.bnb import BnbParams, register
from tests.conftest import random_rotation
from tests.oracle_goicp import oracle_min_sse, _sse


def test_optimality_smoke_vs_oracle():
    """Always-on miniature of the slow matrix below (VERDICT r1 §9): ≤20
    points, coarse everything — still an end-to-end never-prune-the-optimum
    check against the independent numpy oracle."""
    rng = np.random.default_rng(3)
    base = (rng.random((36, 3)).astype(np.float32) - 0.5) * 0.6
    src = base[:18]
    R_true = random_rotation(rng)
    t_true = (rng.random(3).astype(np.float32) - 0.5) * 0.2
    tgt = ((base[14:] @ R_true.T) + t_true).astype(np.float32)

    mse = 2e-4
    o_sse, _, _ = oracle_min_sse(src, tgt, trans_span=0.5, mse_threshold=mse)
    res = register(
        src,
        tgt,
        BnbParams(
            mse_threshold=mse,
            trans_span=0.5,
            se3_pop=48,
            max_rounds=1500,
            max_wall_s=240.0,
            init_multistart=4,
        ),
    )
    got = _sse(
        np.asarray(src, np.float64),
        np.asarray(tgt, np.float64),
        np.asarray(res.transform.R, np.float64),
        np.asarray(res.transform.t, np.float64),
    )
    eps = mse * src.shape[0]
    assert got <= o_sse + 2 * eps, (got, o_sse)


def test_trimmed_lockstep_optimality_vs_oracle():
    """Trimmed LOCKSTEP multipair vs the trimmed numpy oracle: the batched
    driver's pose must reach the oracle's ε-optimal trimmed SSE on both
    pairs (never-prune-the-optimum, trimmed semantics)."""
    from goicp_tpu.multipair import register_pairs

    rng = np.random.default_rng(11)
    trim = 0.3
    mse = 2e-4
    pairs, oracles = [], []
    for _ in range(2):
        src = (rng.random((16, 3)).astype(np.float32) - 0.5) * 0.6
        R_true = random_rotation(rng)
        t_true = (rng.random(3).astype(np.float32) - 0.5) * 0.2
        keep = rng.choice(16, 11, replace=False)   # h = 11 = 16·(1−0.3)
        tgt = ((src[keep] @ R_true.T) + t_true).astype(np.float32)
        pairs.append((src, tgt))
        o_sse, _, _ = oracle_min_sse(
            src, tgt, trans_span=0.5, mse_threshold=mse, trim_fraction=trim
        )
        oracles.append(o_sse)

    results = register_pairs(
        pairs,
        BnbParams(
            mse_threshold=mse, trim_fraction=trim, trans_span=0.5,
            se3_pop=48, max_rounds=1500, max_wall_s=240.0,
            init_multistart=4,
        ),
    )
    for (src, tgt), res, o_sse in zip(pairs, results, oracles):
        moved = (
            np.asarray(src, np.float64)
            @ np.asarray(res.transform.R, np.float64).T
            + np.asarray(res.transform.t, np.float64)
        )
        d2 = (
            ((moved[:, None, :] - np.asarray(tgt, np.float64)[None]) ** 2)
            .sum(-1)
            .min(1)
        )
        h = int(round(src.shape[0] * (1.0 - trim)))
        got = float(np.sort(d2)[:h].sum())
        eps = mse * h
        assert got <= o_sse + 2 * eps, (got, o_sse)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 7])
def test_solver_matches_oracle_min_sse(seed):
    rng = np.random.default_rng(seed)
    # tiny clouds: DIFFERENT samplings so the optimum SSE is nonzero and the
    # certification is non-trivial
    base = (rng.random((80, 3)).astype(np.float32) - 0.5) * 0.6
    src = base[:40]
    R_true = random_rotation(rng)
    t_true = (rng.random(3).astype(np.float32) - 0.5) * 0.2
    tgt = ((base[30:] @ R_true.T) + t_true).astype(np.float32)

    mse = 1e-4
    o_sse, _, _ = oracle_min_sse(src, tgt, trans_span=0.5, mse_threshold=mse)

    res = register(
        src,
        tgt,
        BnbParams(
            mse_threshold=mse,
            trans_span=0.5,
            se3_pop=64,
            max_rounds=3000,
            max_wall_s=900.0,
            init_multistart=8,
        ),
    )
    # verify the returned pose's TRUE (exact-NN) SSE against the oracle
    got = _sse(
        np.asarray(src, np.float64),
        np.asarray(tgt, np.float64),
        np.asarray(res.transform.R, np.float64),
        np.asarray(res.transform.t, np.float64),
    )
    eps = mse * src.shape[0]
    # core optimality claim: the solver's pose is as good as the oracle's
    assert got <= o_sse + 2 * eps, (got, o_sse)
    # full ε-certification (gap closure) is budget-bound on the CPU test
    # backend; assert it only when the budget wasn't the stopper
    if res.rounds < 3000 and res.wall_s < 890:
        assert res.converged
