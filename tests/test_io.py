import numpy as np
import pytest

from goicp_tpu.io import (
    load_cloud,
    read_ply,
    read_txt,
    write_ply,
    write_txt,
    write_result_toml,
)
from goicp_tpu.io.loader import subsample_cloud

from goicp_tpu.io.generated import DATA_DIR, load_gt, load_pair

# the in-repo fixtures and the vertex counts their PLY headers state
GENERATED = {
    "rotated_bunny": 40256,
    "rotated_dragon": 75305,
    "model_skull": 98359,
    "model_spanner": 150000,
    "flipped_model_face": 30730,
}


def test_ply_roundtrip_binary(tmp_path, rng):
    pts = rng.normal(size=(257, 3)).astype(np.float32)
    p = tmp_path / "c.ply"
    write_ply(str(p), pts, binary=True)
    out = read_ply(str(p))
    np.testing.assert_array_equal(out, pts)


def test_ply_roundtrip_ascii_with_colors(tmp_path, rng):
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    cols = rng.integers(0, 255, size=(64, 3)).astype(np.uint8)
    p = tmp_path / "c.ply"
    write_ply(str(p), pts, colors=cols, binary=False)
    out = read_ply(str(p))
    np.testing.assert_allclose(out, pts, atol=1e-5)


def test_txt_roundtrip(tmp_path, rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    p = tmp_path / "c.txt"
    write_txt(str(p), pts)
    out = read_txt(str(p))
    np.testing.assert_allclose(out, pts, atol=1e-5)


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generated_plys_load(name):
    """Each data_generated/ PLY (binary little-endian) loads with the
    vertex count its header states."""
    pts = read_ply(str(DATA_DIR / f"{name}.ply"))
    assert pts.shape == (GENERATED[name], 3)
    assert np.isfinite(pts).all()


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generated_gt_poses(name):
    """Each GT TOML holds a proper rotation, and its inverse recovers a
    source cloud that the stated transform maps back onto the target."""
    gt = load_gt(name)
    R = gt["R"]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-6)
    assert gt["source"] and gt["noise_std"] == 0.0
    src, tgt, R32, t32 = load_pair(name)
    assert src.shape == tgt.shape == (GENERATED[name], 3)
    scale = np.abs(tgt).max()
    np.testing.assert_allclose(src @ R32.T + t32, tgt, atol=1e-5 * scale)


def test_generated_bunny_scan():
    """bun000 recovered from the rotated fixture: the 40256-point scan."""
    src, _, _, _ = load_pair("rotated_bunny")
    assert src.shape == (40256, 3)
    assert np.isfinite(src).all()
    # sanity: bunny is ~0.15 units tall
    assert 0.05 < src[:, 1].max() - src[:, 1].min() < 0.5


def test_subsample_cap_and_determinism(rng):
    pts = rng.normal(size=(10000, 3)).astype(np.float32)
    a = subsample_cloud(pts, 0.1, seed=7)
    b = subsample_cloud(pts, 0.1, seed=7)
    np.testing.assert_array_equal(a, b)
    assert a.shape[0] <= 1000  # cap at floor(n*subsample), common.cpp:115
    assert a.shape[0] > 800  # Bernoulli(0.1) of 10k is near 1000


def test_load_cloud_resize(tmp_path, rng):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    p = tmp_path / "c.txt"
    write_txt(str(p), pts)
    out = load_cloud(str(p), resize=15.0)
    np.testing.assert_allclose(out, pts * 15.0, atol=1e-4)


def test_result_toml_roundtrip(tmp_path):
    import tomllib

    path = tmp_path / "output.toml"
    R = np.eye(3)
    write_result_toml(
        str(path), R, np.array([1.0, 2.0, 3.0]), mse=1e-4, sse=0.3,
        rot_nodes=5, trans_nodes=10, wall_s=1.5, extra={"scenario": "bunny"},
    )
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    np.testing.assert_allclose(doc["result"]["rotation"], R)
    np.testing.assert_allclose(doc["result"]["translation"], [1.0, 2.0, 3.0])
    assert doc["stats"]["trans_nodes"] == 10
    assert doc["extra"]["scenario"] == "bunny"
