"""Test environment: run everything on a virtual 8-device CPU mesh.

Multi-device behavior is testable without accelerators via
``--xla_force_host_platform_device_count`` (SURVEY §4 implication).
Must run before the first ``import jax``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

# the tests run on the virtual CPU mesh even where an accelerator plugin
# is installed
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the fused Pallas kernels in the Pallas interpreter: the CPU has
    no compiled kernel route, so tests that reach the kernels through the
    solver (bound_backend "mxu"/"screen") opt in here."""
    import functools

    from goicp_tpu.nn import mxu

    for name in ("bounds_nodes", "min_d2_groups", "min_d2_nodes"):
        monkeypatch.setattr(
            mxu, name, functools.partial(getattr(mxu, name), interpret=True)
        )


def random_rotation(rng) -> np.ndarray:
    """Uniform random rotation matrix (QR-based)."""
    A = rng.normal(size=(3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q.astype(np.float32)
