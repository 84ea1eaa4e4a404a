"""Multi-chip SE(3) engine: sharded round vs the single-chip round, and a
FULL tiny solve on the virtual 8-device mesh vs the 1-device solve (VERDICT
r1 item 1; SURVEY §4 multi-host-tests-on-CPU-mesh implication)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from goicp_tpu.bnb.se3 import evaluate_se3_nodes
from goicp_tpu.dist.se3 import make_sharded_se3_round, pad_points
from goicp_tpu.dist.sharding import make_mesh
from goicp_tpu.icp import IcpParams
from goicp_tpu.nn.grid import build_distance_grid
from tests.conftest import random_rotation


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(9)
    src = (rng.random((300, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((256, 3)).astype(np.float32) - 0.5) * 0.6
    grid = build_distance_grid(
        tgt, n=16, cover=np.array([[1.5] * 3, [-1.5] * 3]), method="brute",
        with_index=True,
    )
    return src, tgt, grid


def _jobs(rng, M):
    Rs = np.stack([random_rotation(rng) for _ in range(M)])
    ang = rng.random(M).astype(np.float32) * 0.4
    t_c = (rng.random((M, 3)).astype(np.float32) - 0.5) * 0.3
    t_s = rng.random(M).astype(np.float32) * 0.1
    return Rs, ang, t_c, t_s


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (1, 8)])
@pytest.mark.parametrize("h_frac", [0.0, 0.9])
def test_sharded_round_matches_single_chip(setup, mesh_shape, h_frac):
    src, tgt, grid = setup
    rng = np.random.default_rng(77)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    N = src.shape[0]
    h = int(N * h_frac) if h_frac else 0
    M = 16
    R, ang, t_c, t_s = _jobs(rng, M)
    mask = np.ones(M, bool)
    mask[-2:] = False

    ub1, lb1 = evaluate_se3_nodes(
        jnp.asarray(src), jnp.asarray(norms), grid, jnp.asarray(tgt),
        jnp.float32(0.0), jnp.asarray(R), jnp.asarray(ang),
        jnp.asarray(t_c), jnp.asarray(t_s), jnp.asarray(mask),
        h=h, lookup="nearest", backend="exact", tile=128, tgt_tile=256,
    )

    mesh = make_mesh(*mesh_shape)
    n_p = mesh_shape[1]
    src_p, norms_p = pad_points(src, norms, n_p, 128)
    rnd = make_sharded_se3_round(
        mesh, h=h, n_valid=N, lookup="nearest", backend="exact",
        tile=128, refine_k=4, icp_params=IcpParams(max_iter=2),
        icp_backend="exact",
    )
    ub2, lb2, R_ref, t_ref, sse_ref, iters = rnd(
        jnp.asarray(src_p), jnp.asarray(norms_p), grid, jnp.asarray(tgt),
        jnp.float32(0.0), jnp.float32(np.inf), jnp.asarray(R),
        jnp.asarray(ang), jnp.asarray(t_c), jnp.asarray(t_s),
        jnp.asarray(mask), jnp.asarray(src),
    )
    f1, f2 = np.asarray(ub1), np.asarray(ub2)
    fin = np.isfinite(f1)
    assert (fin == np.isfinite(f2)).all()
    np.testing.assert_allclose(f2[fin], f1[fin], rtol=2e-5, atol=1e-6)
    g1, g2 = np.asarray(lb1), np.asarray(lb2)
    np.testing.assert_allclose(g2[fin], g1[fin], rtol=2e-5, atol=1e-6)
    # refinement epilogue ran on the true top-k (finite SSEs, valid poses)
    assert np.isfinite(np.asarray(sse_ref)).all()
    det = np.linalg.det(np.asarray(R_ref))
    np.testing.assert_allclose(det, 1.0, atol=1e-3)


def test_sharded_mxu_round_matches_single_chip(setup, interpret_kernels):
    """The per-point Pallas kernel under shard_map (interpret mode on CPU):
    node-shard × point-shard blocks reproduce the single-chip
    ``evaluate_se3_nodes_mxu`` bounds."""
    from goicp_tpu.bnb.se3 import evaluate_se3_nodes_mxu

    src, tgt, grid = setup
    rng = np.random.default_rng(3)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    N = src.shape[0]
    M = 8
    R, ang, t_c, t_s = _jobs(rng, M)
    mask = np.ones(M, bool)

    ub1, lb1 = evaluate_se3_nodes_mxu(
        jnp.asarray(src), jnp.asarray(norms), jnp.asarray(tgt),
        jnp.float32(0.0), jnp.asarray(R), jnp.asarray(ang),
        jnp.asarray(t_c), jnp.asarray(t_s), jnp.asarray(mask), h=0,
    )
    mesh = make_mesh(2, 2)
    src_p, norms_p = pad_points(src, norms, 2, 1024)
    rnd = make_sharded_se3_round(
        mesh, h=0, n_valid=N, lookup="nearest", backend="mxu",
        tile=128, refine_k=2, icp_params=IcpParams(max_iter=1),
        icp_backend="exact",
    )
    ub2, lb2, *_ = rnd(
        jnp.asarray(src_p), jnp.asarray(norms_p), grid, jnp.asarray(tgt),
        jnp.float32(0.0), jnp.float32(np.inf), jnp.asarray(R),
        jnp.asarray(ang), jnp.asarray(t_c), jnp.asarray(t_s),
        jnp.asarray(mask), jnp.asarray(src),
    )
    np.testing.assert_allclose(np.asarray(ub2), np.asarray(ub1),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(lb2), np.asarray(lb1),
                               rtol=2e-5, atol=1e-6)


def test_sharded_screen_round_matches_single_chip(setup, interpret_kernels):
    """The SCREENED fused kernel under a cube-only mesh (FUTURE lever 8):
    each shard screens its own node slice against the global threshold.
    With thresh=inf the screen never fires, so bounds must equal the plain
    fused kernel's; with a finite thresh, surviving lbs must be unchanged
    and screened-out lbs must still be VALID lower bounds (≥ not required
    — screened lbs are partial sums, so ≤ the full lb and > thresh)."""
    from goicp_tpu.bnb.se3 import evaluate_se3_nodes_mxu

    src, tgt, grid = setup
    rng = np.random.default_rng(4)
    norms = np.linalg.norm(src, axis=1).astype(np.float32)
    N = src.shape[0]
    M = 8
    R, ang, t_c, t_s = _jobs(rng, M)
    mask = np.ones(M, bool)

    ub1, lb1 = evaluate_se3_nodes_mxu(
        jnp.asarray(src), jnp.asarray(norms), jnp.asarray(tgt),
        jnp.float32(0.0), jnp.asarray(R), jnp.asarray(ang),
        jnp.asarray(t_c), jnp.asarray(t_s), jnp.asarray(mask), h=0,
    )
    mesh = make_mesh(4, 1)
    src_p, norms_p = pad_points(src, norms, 1, 128)
    rnd = make_sharded_se3_round(
        mesh, h=0, n_valid=N, lookup="nearest", backend="screen",
        tile=128, refine_k=2, icp_params=IcpParams(max_iter=1),
        icp_backend="exact",
    )
    ub2, lb2, *_ = rnd(
        jnp.asarray(src_p), jnp.asarray(norms_p), grid, jnp.asarray(tgt),
        jnp.float32(0.0), jnp.float32(np.inf), jnp.asarray(R),
        jnp.asarray(ang), jnp.asarray(t_c), jnp.asarray(t_s),
        jnp.asarray(mask), jnp.asarray(src),
    )
    np.testing.assert_allclose(np.asarray(ub2), np.asarray(ub1),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(lb2), np.asarray(lb1),
                               rtol=2e-5, atol=1e-6)

    # finite threshold: every reported lb stays a valid lower bound of the
    # full lb (screened-out nodes report their partial sum, which crossed
    # the threshold — so pruning against thresh is still exact)
    thr = float(np.median(np.asarray(lb1)))
    _, lb3, *_ = rnd(
        jnp.asarray(src_p), jnp.asarray(norms_p), grid, jnp.asarray(tgt),
        jnp.float32(0.0), jnp.float32(thr), jnp.asarray(R),
        jnp.asarray(ang), jnp.asarray(t_c), jnp.asarray(t_s),
        jnp.asarray(mask), jnp.asarray(src),
    )
    lb3 = np.asarray(lb3)
    lb1n = np.asarray(lb1)
    assert (lb3 <= lb1n + 1e-5 * np.maximum(lb1n, 1.0)).all()
    pruned = lb3 < lb1n - 1e-5 * np.maximum(lb1n, 1.0)
    assert (lb3[pruned] > thr).all()


def _tiny_problem():
    rng = np.random.default_rng(21)
    src = (rng.random((48, 3)).astype(np.float32) - 0.5)
    R_true = random_rotation(rng)
    t_true = np.array([0.15, -0.1, 0.05], np.float32)
    tgt = (src @ R_true.T + t_true).astype(np.float32)
    return src, tgt, R_true, t_true


def test_full_solve_parity_on_mesh():
    """A FULL Go-ICP solve sharded over the 8-device mesh lands on the same
    pose as the single-chip solve (and the known ground truth)."""
    from goicp_tpu.bnb import BnbParams, make_solver

    src, tgt, R_true, t_true = _tiny_problem()
    kw = dict(
        mse_threshold=1e-4,
        engine="se3",
        bound_backend="exact",
        se3_pop=32,
        init_multistart=4,
        refine_top_k=4,
        pipeline_depth=1,
        max_rounds=400,
    )
    res1 = make_solver(src, tgt, BnbParams(**kw)).run()
    res8 = make_solver(
        src, tgt, BnbParams(mesh_cubes=4, mesh_points=2, **kw)
    ).run()
    assert res1.converged and res8.converged
    # both land on the ground-truth pose
    for res in (res1, res8):
        np.testing.assert_allclose(res.transform.R, R_true, atol=2e-3)
        np.testing.assert_allclose(res.transform.t, t_true, atol=2e-3)
    # and on each other
    np.testing.assert_allclose(
        res8.transform.R, res1.transform.R, atol=2e-3
    )
    assert abs(res8.mse - res1.mse) < 1e-5


def test_full_solve_parity_trimmed_mesh():
    """Trimmed (robust) solve on the mesh: distributed bisect trimmed sums
    drive the same result as single-chip."""
    from goicp_tpu.bnb import BnbParams, make_solver

    src, tgt, R_true, t_true = _tiny_problem()
    # corrupt 10% of the target with outliers
    rng = np.random.default_rng(5)
    tgt = tgt.copy()
    tgt[:5] += rng.normal(size=(5, 3)).astype(np.float32) * 2.0
    kw = dict(
        mse_threshold=1e-4,
        trim_fraction=0.2,
        engine="se3",
        bound_backend="exact",
        se3_pop=32,
        init_multistart=4,
        refine_top_k=4,
        pipeline_depth=1,
        max_rounds=400,
    )
    res1 = make_solver(src, tgt, BnbParams(**kw)).run()
    res8 = make_solver(
        src, tgt, BnbParams(mesh_cubes=2, mesh_points=4, **kw)
    ).run()
    assert res1.converged and res8.converged
    np.testing.assert_allclose(res8.transform.R, R_true, atol=5e-3)
    np.testing.assert_allclose(res8.transform.R, res1.transform.R, atol=5e-3)


def test_mesh_certification_frontier_loop():
    """Certification-SCALE mesh run (VERDICT r4 item 4's suite twin of the
    dryrun block): a trimmed noisy pair below the noise-floor optimum runs
    thousands of nodes of genuine multi-round certification through the
    mesh path — frontier pops, prune, job-count bucketing, trimmed
    distributed reductions — and must match the single-chip engine's
    incumbent and gap at the shared round budget."""
    from goicp_tpu.bnb import BnbParams, make_solver

    rng = np.random.default_rng(31)
    src = (rng.random((120, 3)).astype(np.float32) - 0.5) * 0.6
    A = rng.normal(size=(3, 3))
    Q, R_ = np.linalg.qr(A)
    Q = (Q * np.sign(np.diag(R_))).astype(np.float32)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    t_true = np.array([0.15, -0.1, 0.05], np.float32)
    tgt = (src @ Q.T + t_true
           + rng.normal(size=src.shape).astype(np.float32) * 0.03)
    tgt[:6] += rng.normal(size=(6, 3)).astype(np.float32) * 1.5
    tgt = tgt.astype(np.float32)
    kw = dict(
        mse_threshold=1.9e-3,    # below the trimmed optimum (~2.0e-3):
                                 # the threshold rule can never fire
        trim_fraction=0.1,
        engine="se3",
        bound_backend="exact",
        se3_pop=64,
        init_multistart=8,
        refine_top_k=4,
        max_rounds=20,           # ~10^4 nodes of frontier dynamics
    )
    res1 = make_solver(src, tgt, BnbParams(**kw)).run()
    res8 = make_solver(
        src, tgt, BnbParams(mesh_cubes=4, mesh_points=2, **kw)
    ).run()
    assert res8.rounds > 1 and res8.rot_nodes >= 5_000, (
        res8.rounds, res8.rot_nodes,
    )
    np.testing.assert_allclose(
        res8.transform.R, res1.transform.R, atol=5e-3
    )
    g1, g8 = max(res1.gap, 1e-9), max(res8.gap, 1e-9)
    assert 0.5 < g8 / g1 < 2.0, (g8, g1)
