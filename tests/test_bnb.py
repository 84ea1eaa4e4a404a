"""BnB correctness tests (SURVEY §4: bound validity, known-pose recovery)."""

import numpy as np
import jax.numpy as jnp
import pytest

from goicp_tpu.bnb import BnbParams, BoundsEvaluator, GoIcpSolver, register
from goicp_tpu.bnb.frontier import Frontier
from goicp_tpu.geo.rotation import (
    axis_angle_rotation,
    quat_cube_rotation,
)
from goicp_tpu.nn.brute import min_dist_sq
from goicp_tpu.nn.grid import build_distance_grid
from tests.conftest import random_rotation


def _cloud(rng, n=200):
    return (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.6


def _true_sse(src, tgt, R, t, h=None):
    pts = src @ np.asarray(R).T + np.asarray(t)
    d2 = np.asarray(min_dist_sq(jnp.asarray(pts), jnp.asarray(tgt)))
    d2 = np.sort(d2)
    if h is not None:
        d2 = d2[:h]
    return float(d2.sum())


@pytest.fixture(scope="module")
def bound_setup():
    rng = np.random.default_rng(7)
    src = (rng.random((150, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((180, 3)).astype(np.float32) - 0.5) * 0.6
    grid = build_distance_grid(tgt, n=96, cover=np.array([[1.5, 1.5, 1.5], [-1.5, -1.5, -1.5]]))
    ev = BoundsEvaluator(src, grid, lookup="trilinear", conservative=True)
    return src, tgt, ev


def test_bounds_bracket_true_sse(bound_setup, rng):
    """For random rotation cubes + translation cubes: the node lb must lower
    bound the true SSE at *any* pose inside the cube, and the center value
    (flag=0) must upper bound the true SSE at the center."""
    src, tgt, ev = bound_setup
    B = 16
    q_c = (rng.random((B, 3)).astype(np.float32) - 0.5) * 1.2
    q_s = rng.random(B).astype(np.float32) * 0.2 + 0.02
    # clamp centers into the unit ball so rotations are valid
    nrm = np.linalg.norm(q_c, axis=1, keepdims=True)
    q_c = np.where(nrm > 0.9, q_c * 0.9 / nrm, q_c)
    t_c = (rng.random((B, 3)).astype(np.float32) - 0.5) * 0.4
    t_s = rng.random(B).astype(np.float32) * 0.15 + 0.02

    from goicp_tpu.geo.rotation import quat_cube_max_angle

    R = np.asarray(quat_cube_rotation(jnp.asarray(q_c)))
    ang = np.asarray(quat_cube_max_angle(jnp.asarray(q_c), jnp.asarray(q_s)))

    ub_cv, _ = ev.evaluate(R, np.zeros(B, np.float32), t_c, np.zeros(B, np.float32),
                           np.zeros(B, np.float32), np.ones(B, bool))
    _, node_lb = ev.evaluate(R, ang, t_c, t_s, np.ones(B, np.float32), np.ones(B, bool))

    for b in range(B):
        # center value upper-bounds the true SSE at the cube center
        sse_center = _true_sse(src, tgt, R[b], t_c[b])
        assert ub_cv[b] >= sse_center - 1e-4, (b, ub_cv[b], sse_center)
        # node lb lower-bounds the true SSE at random poses inside the cube
        for _ in range(5):
            dq = (rng.random(3) - 0.5) * 2 * q_s[b]
            dt = (rng.random(3) - 0.5) * 2 * t_s[b]
            qi = q_c[b] + dq.astype(np.float32)
            if np.linalg.norm(qi) > 1.0:
                continue
            Ri = np.asarray(quat_cube_rotation(jnp.asarray(qi)))
            sse_i = _true_sse(src, tgt, Ri, t_c[b] + dt.astype(np.float32))
            assert node_lb[b] <= sse_i + 1e-4, (b, node_lb[b], sse_i)


def test_bounds_trimmed_bracket(bound_setup, rng):
    src, tgt, _ = bound_setup
    grid = build_distance_grid(
        tgt, n=96, cover=np.array([[1.5, 1.5, 1.5], [-1.5, -1.5, -1.5]])
    )
    tf = 0.2
    ev = BoundsEvaluator(src, grid, trim_fraction=tf, conservative=True)
    B = 8
    t_c = (rng.random((B, 3)).astype(np.float32) - 0.5) * 0.3
    t_s = rng.random(B).astype(np.float32) * 0.1 + 0.02
    R = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    zeros = np.zeros(B, np.float32)
    cv, lb = ev.evaluate(R, zeros, t_c, t_s, zeros, np.ones(B, bool))
    for b in range(B):
        sse_c = _true_sse(src, tgt, np.eye(3), t_c[b], h=ev.h)
        assert cv[b] >= sse_c - 1e-4
        for _ in range(4):
            dt = (rng.random(3) - 0.5) * 2 * t_s[b]
            sse_i = _true_sse(src, tgt, np.eye(3), t_c[b] + dt.astype(np.float32), h=ev.h)
            assert lb[b] <= sse_i + 1e-4


def test_frontier_ops():
    f = Frontier()
    f.push(np.zeros((3, 3)), [1.0, 2.0, 3.0], [0.5, 0.1, 0.9])
    assert len(f) == 3
    c, s, lb, ub = f.pop_best(2)
    assert np.allclose(sorted(lb.tolist()), [0.1, 0.5])
    f.push(np.zeros((2, 3)), [1.0, 1.0], [5.0, 0.01])
    assert f.prune(1.0) == 1  # drops lb 5.0; 0.9 and 0.01 survive
    assert np.isclose(f.min_lb(), 0.01)


def test_frontier_lb_ties_break_by_ub():
    f = Frontier()
    f.push(np.zeros((3, 3)), [1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [3.0, 1.0, 2.0])
    _, _, _, ub = f.pop_best(1)
    assert np.isclose(ub[0], 1.0)


@pytest.mark.parametrize("param", ["quaternion", "axis_angle"])
def test_goicp_recovers_large_rotation(param):
    """The global solver must recover a pose far outside ICP's basin."""
    rng = np.random.default_rng(3)
    src = (rng.random((300, 3)).astype(np.float32) - 0.5) * 0.6
    R_true = random_rotation(rng)
    t_true = (rng.random(3).astype(np.float32) - 0.5) * 0.4
    tgt = (src @ R_true.T + t_true).astype(np.float32)

    params = BnbParams(
        mse_threshold=1e-5,
        rotation_param=param,
        grid_resolution=64,
        rot_pop=2,
        inner_cap=16,
        inner_levels=8,
        max_rounds=60,
    )
    res = register(src, tgt, params)
    pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
    rmse = float(np.sqrt(np.mean(np.sum((pts - tgt) ** 2, axis=1))))
    assert rmse < 2e-3, (rmse, res.sse, res.converged, res.rounds)
    assert res.converged


def test_goicp_trimmed_with_outliers():
    rng = np.random.default_rng(11)
    src = (rng.random((250, 3)).astype(np.float32) - 0.5) * 0.6
    R_true = random_rotation(rng)
    t_true = np.array([0.1, -0.05, 0.2], np.float32)
    src_noisy = np.concatenate(
        [src, (rng.random((30, 3)).astype(np.float32) - 0.5) * 2.0]
    ).astype(np.float32)
    tgt = (src @ R_true.T + t_true).astype(np.float32)
    params = BnbParams(
        mse_threshold=1e-5,
        trim_fraction=0.15,
        grid_resolution=64,
        rot_pop=2,
        inner_cap=16,
        inner_levels=8,
        max_rounds=60,
    )
    res = register(src_noisy, tgt, params)
    pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
    rmse = float(np.sqrt(np.mean(np.sum((pts - tgt) ** 2, axis=1))))
    assert rmse < 5e-3, (rmse, res.sse, res.converged)


def test_trimmed_sum_bisect_matches_sort(rng):
    from goicp_tpu.bnb.se3 import _trimmed_sum_bisect
    import jax.numpy as jnp

    x = (rng.random((6, 500)).astype(np.float32)) ** 2 * 3.0
    x[:, 480:] = 1e30  # padding sentinels must never count as inliers
    for h in (1, 100, 400, 480):
        lo = np.asarray(_trimmed_sum_bisect(jnp.asarray(x), h, upper=False))
        hi = np.asarray(_trimmed_sum_bisect(jnp.asarray(x), h, upper=True))
        want = np.sort(x, axis=1)[:, :h].sum(1)
        assert np.all(lo <= want + 1e-3), (h, lo - want)
        assert np.all(hi >= want - 1e-3), (h, want - hi)
        assert np.allclose(lo, want, rtol=1e-3, atol=1e-3)
        assert np.allclose(hi, want, rtol=1e-3, atol=1e-3)


def test_nested_engine_recovers():
    """The reference-shaped nested engine (outer SO(3) / inner R³) stays
    functional as an alternative to the SE(3) product engine."""
    rng = np.random.default_rng(21)
    src = (rng.random((200, 3)).astype(np.float32) - 0.5) * 0.6
    R_true = random_rotation(rng)
    t_true = np.array([0.08, -0.06, 0.1], np.float32)
    tgt = (src @ R_true.T + t_true).astype(np.float32)
    res = register(
        src,
        tgt,
        BnbParams(
            mse_threshold=1e-5,
            engine="nested",
            rot_pop=2,
            inner_cap=16,
            inner_levels=8,
            max_rounds=40,
        ),
    )
    pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
    rmse = float(np.sqrt(np.mean(np.sum((pts - tgt) ** 2, axis=1))))
    assert rmse < 2e-3


def test_engines_agree_on_pose():
    """The flat SE(3) product engine and the reference-shaped nested engine
    must converge to the same pose on the same problem (both ε-certify the
    same objective)."""
    rng = np.random.default_rng(21)
    src = (rng.random((200, 3)).astype(np.float32) - 0.5) * 0.6
    R_true = random_rotation(rng)
    t_true = np.array([0.08, -0.06, 0.1], np.float32)
    tgt = (src @ R_true.T + t_true).astype(np.float32)

    res_a = register(
        src, tgt, BnbParams(mse_threshold=1e-5, engine="se3", se3_pop=64,
                            max_rounds=80)
    )
    res_b = register(
        src, tgt, BnbParams(mse_threshold=1e-5, engine="nested", rot_pop=2,
                            inner_cap=16, inner_levels=8, max_rounds=40)
    )
    assert np.allclose(res_a.transform.R, res_b.transform.R, atol=2e-3)
    assert np.allclose(res_a.transform.t, res_b.transform.t, atol=2e-3)
    assert abs(res_a.mse - res_b.mse) < 1e-6


def test_coarse_to_fine_multistart_recovers():
    """With the coarse seed stage forced on (init_coarse_n below the cloud
    size), the solver still recovers a pose far outside ICP's basin — the
    full-resolution refine of the top coarse seeds preserves the incumbent
    quality, and the identity start stays pinned."""
    rng = np.random.default_rng(17)
    src = (rng.random((320, 3)).astype(np.float32) - 0.5) * 0.6
    R_true = random_rotation(rng)
    t_true = (rng.random(3).astype(np.float32) - 0.5) * 0.4
    tgt = (src @ R_true.T + t_true).astype(np.float32)

    res = register(
        src, tgt,
        BnbParams(mse_threshold=1e-5, init_coarse_n=64, se3_pop=64,
                  max_rounds=80),
    )
    pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
    rmse = float(np.sqrt(np.mean(np.sum((pts - tgt) ** 2, axis=1))))
    assert rmse < 2e-3, (rmse, res.converged)


def test_screened_solve_matches_unscreened(interpret_kernels):
    """The progressive-screening backend ("screen", interpret mode on CPU)
    must converge to the same pose as the unscreened "mxu" path — screening
    only skips work on nodes whose partial lb already proves them prunable."""
    rng = np.random.default_rng(11)
    src = (rng.random((200, 3)).astype(np.float32) - 0.5) * 0.6
    R_true = random_rotation(rng)
    t_true = (rng.random(3).astype(np.float32) - 0.5) * 0.3
    tgt = (src @ R_true.T + t_true).astype(np.float32)

    kw = dict(mse_threshold=1e-5, se3_pop=64, max_rounds=80,
              bound_backend="mxu")
    res_s = register(src, tgt, BnbParams(screen=True, **kw))
    res_u = register(src, tgt, BnbParams(screen=False, **kw))
    for res in (res_s, res_u):
        pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
        rmse = float(np.sqrt(np.mean(np.sum((pts - tgt) ** 2, axis=1))))
        assert rmse < 2e-3, (rmse, res.converged)
    assert res_s.converged == res_u.converged
    assert abs(res_s.mse - res_u.mse) < 1e-6


def test_full_cloud_certificate_transfer(rng):
    """VERDICT r4 item 8: a bound_points-capped solve carries a FULL-cloud
    optimality statement (sse_full/mse_full/gap_full), sound against an
    uncapped full-cloud solve."""
    import dataclasses

    from goicp_tpu.bnb import BnbParams, make_solver

    tgt = (rng.random((260, 3)).astype(np.float32) - 0.5)
    Q = random_rotation(rng)
    t = (rng.random(3).astype(np.float32) - 0.5) * 0.2
    src_full = ((tgt - t) @ Q).astype(np.float32)     # full cloud, exact GT

    p_cap = BnbParams(
        mse_threshold=1e-4, bound_points=120, grid_resolution=24,
        max_rounds=400, init_multistart=4, se3_pop=64,
    )
    res = make_solver(src_full, tgt, p_cap).run()
    assert res.converged
    assert res.sse_full is not None and res.gap_full is not None
    assert res.gap_full >= 0.0
    n_full = src_full.shape[0]
    assert res.mse_full == pytest.approx(res.sse_full / n_full)
    # sse_full really is the full-cloud score at the returned pose
    pts = src_full @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
    d2 = ((pts[:, None, :] - tgt[None]) ** 2).sum(-1).min(1)
    assert res.sse_full == pytest.approx(float(d2.sum()), rel=1e-3, abs=1e-6)

    # SOUNDNESS: the claimed full-cloud lower bound (sse_full - gap_full)
    # must not exceed any ACHIEVED full-cloud sse — here the uncapped
    # solve's, which solves the full cloud directly
    p_un = dataclasses.replace(p_cap, bound_points=1 << 30)
    res_un = make_solver(src_full, tgt, p_un).run()
    assert res_un.sse_full is None and res_un.gap_full is None  # no subset
    assert res.sse_full - res.gap_full <= res_un.sse + 1e-6

    # trimmed solves keep gap_full=None (the trimmed-sum transfer is
    # invalid — see GoIcpResult field docs) but still report sse_full
    p_tr = dataclasses.replace(p_cap, trim_fraction=0.2, mse_threshold=1e-3)
    res_tr = make_solver(src_full, tgt, p_tr).run()
    assert res_tr.sse_full is not None and res_tr.gap_full is None
