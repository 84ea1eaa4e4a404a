"""The one device gate: which compiled-kernel route the default device has.

Every platform-dependent choice in the package reads :func:`kernel_route`
(bound-backend selection, the lockstep gate, the kernel wrappers), so the
decision is made in one place from what JAX reports.
"""

from __future__ import annotations

from typing import Optional

import jax


def kernel_route() -> Optional[str]:
    """``"triton"`` when the default device is a GPU (the fused bound
    kernels compile through Pallas' Triton route), ``None`` otherwise — on
    the CPU the plain XLA paths run and the kernels only run when a caller
    asks for interpret mode explicitly."""
    return "triton" if jax.devices()[0].platform == "gpu" else None
