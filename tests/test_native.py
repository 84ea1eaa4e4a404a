"""Native C++ runtime vs numpy/Python oracles."""

import ctypes

import numpy as np
import pytest

from goicp_tpu import _native
from goicp_tpu.bnb.frontier import Frontier, NativeFrontier, PyFrontier


@pytest.fixture(scope="module")
def lib():
    l = _native.lib()
    if l is None:
        pytest.skip("native runtime unavailable")
    return l


def test_native_frontier_matches_numpy(lib, rng):
    from goicp_tpu.bnb.frontier import Frontier as _F, NativeFrontier as _NF
    nf, pf = _F(_NF(4)), _F()
    for _ in range(5):
        n = int(rng.integers(1, 50))
        c = rng.random((n, 3)).astype(np.float32)
        s = rng.random(n).astype(np.float32)
        lb = rng.random(n).astype(np.float32)
        ub = rng.random(n).astype(np.float32)
        nf.push(c, s, lb, ub)
        pf.push(c, s, lb, ub)
    assert len(nf) == len(pf)
    assert np.isclose(nf.min_lb(), pf.min_lb())
    nc, ns, nl, nu = nf.pop_best(17)
    pc, ps, pl, pu = pf.pop_best(17)
    # same SET of best-lb cubes (internal order may differ)
    assert np.allclose(np.sort(nl), np.sort(pl))
    assert len(nf) == len(pf)
    thresh = float(np.median(nl)) + 0.1
    assert nf.prune(thresh) == pf.prune(thresh)
    assert np.isclose(nf.min_lb(), pf.min_lb())


def test_native_frontier_pop_order(lib):
    from goicp_tpu.bnb.frontier import Frontier as _F, NativeFrontier as _NF
    nf = _F(_NF(4))
    nf.push(np.zeros((3, 3)), [1.0, 1.0, 1.0], [0.3, 0.1, 0.2], [9.0, 8.0, 7.0])
    _, _, lb, _ = nf.pop_best(2)
    assert np.allclose(np.sort(lb), [0.1, 0.2])
    # lb ties break by ub
    nf2 = _F(_NF(4))
    nf2.push(np.zeros((2, 3)), [1.0, 1.0], [0.0, 0.0], [5.0, 2.0])
    _, _, _, ub = nf2.pop_best(1)
    assert np.isclose(ub[0], 2.0)


def test_select_kth_and_trimmed_sum(lib, rng):
    v = rng.random(1000).astype(np.float32)
    arr, p = _native.as_f32p(v)
    for k in (0, 10, 500, 999):
        assert np.isclose(lib.gn_select_kth(p, 1000, k), np.sort(v)[k])
    for h in (1, 100, 1000):
        want = float(np.sort(v)[:h].sum())
        assert np.isclose(lib.gn_trimmed_sum(p, 1000, h), want, rtol=1e-5)


def test_native_txt_roundtrip(lib, tmp_path, rng):
    from goicp_tpu.io.txt import _read_txt_native, read_txt, write_txt

    pts = rng.normal(size=(500, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.txt")
    write_txt(path, pts)
    native = _read_txt_native(path)
    assert native is not None
    assert np.allclose(native, pts, atol=1e-5)
    assert np.allclose(read_txt(path), native)


def test_native_txt_reads_full_scan(lib, tmp_path):
    """The native reader on a full-size scan: bun000 (40256 points)
    recovered from the in-repo fixture, written as text."""
    from goicp_tpu.io.generated import load_pair
    from goicp_tpu.io.txt import _read_txt_native, write_txt

    src, _, _, _ = load_pair("rotated_bunny")
    path = str(tmp_path / "bun000.txt")
    write_txt(path, src)
    pts = _read_txt_native(path)
    assert pts is not None and pts.shape == (40256, 3)
    assert np.isfinite(pts).all()
    np.testing.assert_allclose(pts, src, atol=1e-5)
