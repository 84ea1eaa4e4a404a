"""Fused bound kernels (nn.mxu): parity with the plain XLA brute force and
numpy oracles, the device gate, and the solver paths that reach them.

The kernels run in the Pallas interpreter here (the CPU has no compiled
route); ``chip_smoke.py`` runs the same kernels compiled on the GPU and
compares them with the same references at full width.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from goicp_tpu.core import device
from goicp_tpu.nn import mxu
from goicp_tpu.nn.brute import min_dist_sq
from tests.conftest import random_rotation

_SIZES = (1, 127, 300, 1518)      # block remainders: 1, 127, 44, 110 (bn=128)


def _scene(rng, n=220, m=330, b=4):
    src = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (rng.random((m, 3)).astype(np.float32) - 0.5) * 0.6
    R = np.stack([random_rotation(rng) for _ in range(b)])
    t = (rng.random((b, 3)).astype(np.float32) - 0.5) * 0.3
    return src, tgt, R, t


def _brute_d2(src, tgt, R, t):
    """Reference per-point min d² ``[B, N]``: ``nn.brute.min_dist_sq`` on
    the transformed points (elementwise f32)."""
    pts = np.einsum("bij,nj->bni", R, src) + t[:, None, :]
    return np.asarray(min_dist_sq(jnp.asarray(pts, jnp.float32),
                                  jnp.asarray(tgt)))


def _oracle_bounds(d2, src, af, gt, slack=0.0):
    """Yang eq. 10 bounds from per-point distances ``d2 [B, N]``."""
    d = np.sqrt(d2.astype(np.float64))
    norms = np.linalg.norm(src, axis=1)
    ub = ((d + slack) ** 2).sum(-1)
    lb = (
        np.maximum(
            np.maximum(d - slack, 0.0) - (af[:, None] * norms + gt[:, None]),
            0.0,
        ) ** 2
    ).sum(-1)
    return ub, lb


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("nt", _SIZES)
def test_bounds_nodes_matches_brute(rng, n, nt):
    """Unscreened fused bounds equal the XLA brute-force bounds for clouds
    that are not multiples of the point block or the target tile."""
    src, tgt, R, t = _scene(rng, n=n, m=nt, b=3)
    af = rng.random(3).astype(np.float32) * 0.3
    gt = rng.random(3).astype(np.float32) * 0.1
    ub_ref, lb_ref = _oracle_bounds(_brute_d2(src, tgt, R, t), src, af, gt)
    params = mxu.pack_params_bounds(R, t, af, gt, 0.0, 1e30)
    ub, lb = map(np.asarray, mxu.bounds_nodes(
        src, np.linalg.norm(src, axis=1), tgt, params, interpret=True
    ))
    np.testing.assert_allclose(ub, ub_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lb, lb_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("nt", _SIZES)
def test_min_d2_nodes_matches_brute(rng, n, nt):
    """Per-point kernel rows equal the brute-force min d² of each node."""
    src, tgt, R, t = _scene(rng, n=n, m=nt, b=3)
    d2 = np.asarray(mxu.min_d2_nodes(src, tgt, R, t, interpret=True))
    assert d2.shape == (3, n + (-n) % mxu.BN)
    np.testing.assert_allclose(d2[:, :n], _brute_d2(src, tgt, R, t),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("nt", _SIZES)
def test_min_d2_groups_matches_brute(rng, n, nt):
    """Grouped kernel rows ``8g+j`` equal the brute-force min d² of node
    ``(R_g, t_{g,j})``; padded columns are left to the caller."""
    src, tgt, Rg, _ = _scene(rng, n=n, m=nt, b=2)
    t8 = (rng.random((2, 8, 3)).astype(np.float32) - 0.5) * 0.3
    ref = _brute_d2(src, tgt, np.repeat(Rg, 8, axis=0), t8.reshape(-1, 3))
    d2 = np.asarray(mxu.min_d2_groups(
        src, tgt, mxu.pack_group_params(Rg, t8), interpret=True
    ))
    assert d2.shape == (16, n + (-n) % mxu.BN)
    # the separable form |u−m|² + 2t·u + |t|² − 2t·m cancels in f32
    np.testing.assert_allclose(d2[:, :n], ref, rtol=1e-5, atol=2e-6)


def test_bounds_nodes_unscreened_matches_oracle(rng):
    src, tgt, R, t = _scene(rng, b=6)
    af = rng.random(6).astype(np.float32) * 0.3
    gt = rng.random(6).astype(np.float32) * 0.1
    q = np.einsum("bij,nj->bni", R.astype(np.float64), src) + t[:, None, :]
    d2 = ((q[:, :, None, :] - tgt[None, None]) ** 2).sum(-1).min(-1)
    ub_ref, lb_ref = _oracle_bounds(d2, src, af, gt, slack=1e-3)
    params = mxu.pack_params_bounds(R, t, af, gt, 1e-3, 1e30)
    ub, lb = map(np.asarray, mxu.bounds_nodes(
        src, np.linalg.norm(src, axis=1), tgt, params, interpret=True
    ))
    assert np.allclose(ub, ub_ref, rtol=1e-5, atol=1e-5), np.abs(ub - ub_ref).max()
    assert np.allclose(lb, lb_ref, rtol=1e-5, atol=1e-5), np.abs(lb - lb_ref).max()


def test_bounds_nodes_screening_is_valid(rng):
    """With a finite threshold, screened nodes report a PARTIAL lb that is
    still a valid lower bound (≤ full lb) and ≥ the threshold; their ub is
    an inf sentinel.  Unscreened nodes match the full evaluation."""
    src, tgt, R, t = _scene(rng, n=512, b=8)
    t = t + np.float32([2.0, 0, 0])      # push far: large lb, screen fires
    t[0] = 0.0                           # ...except node 0 (small lb)
    af = np.full(8, 0.05, np.float32)
    gt = np.full(8, 0.02, np.float32)
    ub_ref, lb_ref = _oracle_bounds(_brute_d2(src, tgt, R, t), src, af, gt)
    thresh = float(np.sort(lb_ref)[1] * 0.5)   # screens the far nodes only
    params = mxu.pack_params_bounds(R, t, af, gt, 0.0, thresh)
    ub, lb = map(np.asarray, mxu.bounds_nodes(
        src, np.linalg.norm(src, axis=1), tgt, params, interpret=True
    ))
    for b in range(8):
        if ub[b] >= 1e29:        # screened
            assert lb[b] >= thresh - 1e-4
            assert lb[b] <= lb_ref[b] + 1e-3
        else:
            assert np.isclose(ub[b], ub_ref[b], rtol=1e-5, atol=1e-5)
            assert np.isclose(lb[b], lb_ref[b], rtol=1e-5, atol=1e-5)
    assert ub[0] < 1e29          # the near node was fully evaluated
    assert (ub[1:] >= 1e29).all()  # ...and every far node screened


def test_pack_sources_pads_invalid_rows():
    """Padded source columns are zero with valid = 0, so they add nothing
    to either bound sum."""
    src = np.ones((130, 3), np.float32)
    packed = np.asarray(mxu.pack_sources(src, np.full(130, 2.0), bn=128))
    assert packed.shape == (5, 256)
    assert (packed[:, 130:] == 0).all()
    assert (packed[3, :130] == 2.0).all() and (packed[4, :130] == 1.0).all()
    tgt = np.asarray(mxu.pack_targets(src, bm=32))
    assert tgt.shape == (3, 160) and (tgt[:, 130:] == mxu._PAD_TGT).all()


def test_evaluate_se3_nodes_mxu_matches_exact_backend(rng, interpret_kernels):
    """The unfused kernel bound evaluation ("mxu") agrees with the XLA
    exact backend (same (ub, lb) semantics, different compute path)."""
    from goicp_tpu.bnb.se3 import evaluate_se3_nodes, evaluate_se3_nodes_mxu
    from goicp_tpu.nn.grid import build_distance_grid

    src, tgt, R, t = _scene(rng, n=150, m=200, b=8)
    norms = jnp.linalg.norm(jnp.asarray(src), axis=-1)
    max_angle = rng.random(8).astype(np.float32)
    t_span = (rng.random(8).astype(np.float32)) * 0.1
    mask = np.ones(8, bool)
    mask[-1] = False

    grid = build_distance_grid(tgt, n=8, method="brute")
    args = (
        jnp.asarray(src), norms, jnp.asarray(tgt), jnp.float32(0.0),
        jnp.asarray(R), jnp.asarray(max_angle), jnp.asarray(t),
        jnp.asarray(t_span), jnp.asarray(mask),
    )
    for h in (0, 120):
        ub_x, lb_x = evaluate_se3_nodes(
            args[0], args[1], grid, *args[2:], h=h, lookup="nearest",
            backend="exact", tile=128, tgt_tile=256,
        )
        ub_m, lb_m = evaluate_se3_nodes_mxu(*args, h=h)
        assert np.allclose(
            np.asarray(ub_m)[mask], np.asarray(ub_x)[mask], rtol=1e-4
        )
        assert np.allclose(
            np.asarray(lb_m)[mask], np.asarray(lb_x)[mask],
            rtol=1e-4, atol=1e-5,
        )
        assert np.isinf(np.asarray(ub_m)[~mask]).all()


def test_screened_evaluator_rejects_trimmed(rng, interpret_kernels):
    """A partial sum of the h smallest terms is no lower bound: the screened
    evaluator refuses trimmed nodes instead of returning unsound bounds."""
    from goicp_tpu.bnb.se3 import evaluate_se3_nodes_screened

    src, tgt, R, t = _scene(rng, n=64, m=64, b=2)
    z = jnp.zeros(2, jnp.float32)
    with pytest.raises(ValueError, match="untrimmed"):
        evaluate_se3_nodes_screened(
            jnp.asarray(src), jnp.ones(64), jnp.asarray(tgt),
            jnp.float32(0.0), jnp.float32(1.0), jnp.asarray(R), z,
            jnp.asarray(t), z, jnp.ones(2, bool), h=50,
        )


def test_solver_runs_with_mxu_backend(rng, interpret_kernels):
    """End-to-end tiny solve on the interpret-mode kernels."""
    from goicp_tpu.bnb import BnbParams, register

    src = (rng.random((60, 3)).astype(np.float32) - 0.5) * 0.6
    R = random_rotation(rng)
    t = np.array([0.08, -0.05, 0.1], np.float32)
    tgt = (src @ R.T + t).astype(np.float32)
    res = register(
        src, tgt,
        BnbParams(
            mse_threshold=1e-5, bound_backend="mxu", se3_pop=8,
            max_rounds=60, init_multistart=4, refine_top_k=2,
        ),
    )
    pts = src @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
    rmse = float(np.sqrt(np.mean(np.sum((pts - tgt) ** 2, axis=1))))
    assert rmse < 5e-3, rmse


def test_forced_screen_on_trimmed_solve_runs_unfused(rng):
    """bound_backend="screen" on a trimmed solve takes the unfused path."""
    from goicp_tpu.bnb import BnbParams, make_solver

    src = (rng.random((40, 3)).astype(np.float32) - 0.5) * 0.6
    s = make_solver(src, src, BnbParams(bound_backend="screen",
                                        trim_fraction=0.1))
    assert s._backend == "mxu"
    s = make_solver(src, src, BnbParams(bound_backend="screen"))
    assert s._backend == "screen"
    s = make_solver(src, src, BnbParams(bound_backend="mxu", screen=False))
    assert s._backend == "mxu"


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,route", [("gpu", "triton"), ("cpu", None)])
def test_kernel_route(monkeypatch, platform, route):
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(platform)])
    assert device.kernel_route() == route


def test_auto_backend_follows_the_route(monkeypatch):
    """``auto`` picks the kernel backend only where a route exists."""
    from goicp_tpu.bnb import BnbParams
    from goicp_tpu.bnb.params import auto_backend

    p = BnbParams()
    assert auto_backend(p, 1800) == "grid"          # CPU: no route
    assert auto_backend(p, 300) == "exact"
    monkeypatch.setattr(device, "kernel_route", lambda: "triton")
    assert auto_backend(p, 1800) == "mxu"
    assert auto_backend(p, p.mxu_max + 1) == "grid"


@pytest.mark.parametrize(
    "kernel", ["bounds_nodes", "min_d2_groups", "min_d2_nodes"]
)
def test_kernel_without_route_raises(rng, kernel):
    """On the CPU a kernel runs only when the caller asks for the
    interpreter explicitly; it never falls back silently."""
    src, tgt, R, t = _scene(rng, n=16, m=16, b=1)
    if kernel == "bounds_nodes":
        args = (src, np.ones(16), tgt,
                mxu.pack_params_bounds(R, t, [0.0], [0.0], 0.0, 1e30))
    elif kernel == "min_d2_nodes":
        args = (src, tgt, R, t)
    else:
        args = (src, tgt, mxu.pack_group_params(R, np.zeros((1, 8, 3))))
    with pytest.raises(RuntimeError, match="interpret=True"):
        getattr(mxu, kernel)(*args)
