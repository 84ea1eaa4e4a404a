from pathlib import Path

import numpy as np
import pytest

from goicp_tpu.core.config import Config, Mode

SCENARIOS = Path(__file__).resolve().parents[1] / "scenarios"


@pytest.mark.parametrize(
    "name,mode,subsample,mse,resize,trim",
    [
        ("bunny_icp.toml", Mode.ICP_GPU, 1.0, 1e-5, 15.0, True),
        ("bunny_goicp.toml", Mode.GOICP_GPU, 0.1, 1e-3, 1.0, False),
        ("bunny_goicp_cpu.toml", Mode.GOICP_CPU, 0.1, 1e-3, 1.0, False),
        ("bunny_gt_goicp.toml", Mode.GOICP_GPU, 0.05, 1e-5, 1.0, False),
        ("dragon_goicp.toml", Mode.GOICP_GPU, 0.05, 1e-5, 1.0, False),
        ("dragon_scans_goicp.toml", Mode.GOICP_GPU, 0.05, 4e-5, 1.0, True),
        ("skull_goicp.toml", Mode.GOICP_GPU, 0.1, 1e-3, 0.01, True),
        ("face_goicp.toml", Mode.GOICP_GPU, 0.1, 5e-3, 0.007, True),
        ("spanner_goicp.toml", Mode.GOICP_GPU, 0.1, 1e-4, 0.02, True),
    ],
)
def test_scenario_tomls_parse(name, mode, subsample, mse, resize, trim):
    """Every repo scenario TOML (the reference's schema) parses with its
    own values."""
    cfg = Config.from_toml(str(SCENARIOS / name))
    assert cfg.mode == mode
    assert cfg.subsample == subsample
    assert cfg.mse_threshold == mse
    assert cfg.resize == resize
    assert cfg.trim is trim
    assert cfg.io.output == "output.toml"


def test_search_bounds_parsed():
    """[params.rotation]/[params.translation] are dead config in the
    reference (common.cpp:20-77 never reads them); here they are honored."""
    cfg = Config.from_toml(str(SCENARIOS / "skull_goicp.toml"))
    assert cfg.rotation.xmin == -180
    assert cfg.rotation.search_depth == 12
    assert cfg.translation.span == 1.0
    assert cfg.translation.center == (0.0, 0.0, 0.0)


def test_path_resolution():
    """io paths resolve against the TOML's own directory."""
    cfg = Config.from_toml(str(SCENARIOS / "bunny_gt_goicp.toml"))
    p = Path(cfg.resolve(cfg.io.target))
    assert p == SCENARIOS.parent / "data_generated" / "rotated_bunny.ply"
    assert p.exists()


def test_tpu_section_defaults_and_override(tmp_path):
    toml = tmp_path / "s.toml"
    toml.write_text(
        """
[io]
target = "t.ply"
source = "s.ply"
[params]
mode = 4
[tpu]
grid_resolution = 128
rotation_param = "axis_angle"
engine = "nested"
bound_backend = "grid"
conservative = true
checkpoint_path = "ck.npz"
checkpoint_every = 7
mesh_cubes = 4
"""
    )
    cfg = Config.from_toml(str(toml))
    assert cfg.tpu.grid_resolution == 128
    assert cfg.tpu.rotation_param == "axis_angle"
    assert cfg.tpu.lookup == "nearest"  # default (ref CPU DT semantics)
    assert cfg.tpu.engine == "nested"
    assert cfg.tpu.bound_backend == "grid"
    assert cfg.tpu.conservative is True
    assert cfg.tpu.checkpoint_path == "ck.npz"
    assert cfg.tpu.checkpoint_every == 7
    assert cfg.tpu.mesh_cubes == 4

    # every [tpu] knob reaches the solver parameters (no dead config —
    # the smell SURVEY §2 C2 called out in the reference)
    from goicp_tpu.cli import bnb_params_from_config

    p = bnb_params_from_config(cfg)
    assert p.engine == "nested"
    assert p.bound_backend == "grid"
    assert p.conservative is True
    assert p.checkpoint_path == "ck.npz"
    assert p.checkpoint_every == 7
    assert p.mesh_cubes == 4


def test_effective_trim_fraction():
    cfg = Config.from_dict({"params": {"trim": True, "trim_fraction": 0.2}})
    assert cfg.effective_trim_fraction == 0.2
    cfg = Config.from_dict({"params": {"trim": False, "trim_fraction": 0.2}})
    assert cfg.effective_trim_fraction == 0.0


def test_bnb_params_enum_validation():
    """Enum typos fail fast at solver construction instead of silently
    routing to a different backend/engine (ADVICE r3, generalized)."""
    import numpy as np
    import pytest

    from goicp_tpu.bnb import BnbParams, make_solver

    src = np.zeros((10, 3), np.float32)
    tgt = np.zeros((12, 3), np.float32)
    for field, bad in (
        ("icp_metric", "Plane"),
        ("engine", "SE3"),
        ("bound_backend", "mxU"),
        ("lookup", "bilinear"),
        ("rotation_param", "euler"),
    ):
        with pytest.raises((ValueError, KeyError)):
            make_solver(src, tgt, BnbParams(**{field: bad}))


def test_auto_backend_economics():
    """ONE source of truth for the auto bound-backend cutoffs, consulted by
    both the solo solver and the lockstep multipair gate (CPU test mesh:
    no kernel route, so the mxu tier is unreachable here)."""
    from goicp_tpu.bnb import BnbParams
    from goicp_tpu.bnb.solver import auto_backend
    from goicp_tpu.multipair import lockstep_compatible

    p = BnbParams()
    assert auto_backend(p, p.exact_max) == "exact"
    assert auto_backend(p, p.exact_max + 1) == "grid"
    # the lockstep gate follows the same economics
    assert lockstep_compatible(p, 100, p.exact_max)
    assert not lockstep_compatible(p, 100, p.exact_max + 1)
    # and the non-backend knobs it does not implement
    import dataclasses

    assert not lockstep_compatible(
        dataclasses.replace(p, engine="nested"), 100, 100
    )
    assert not lockstep_compatible(
        dataclasses.replace(p, checkpoint_path="/tmp/x"), 100, 100
    )
