"""Core data types: rigid transforms, BnB cube batches, bounds.

Batched counterparts of the reference's node structs
(``src/common.h:25-131``: ``Rotation``, ``RotNode``, ``TransNode``).  Where the
reference keeps one node per C++ struct ordered in a ``std::priority_queue``,
this framework keeps *batches* of cubes as structure-of-arrays so an entire
frontier slice is evaluated in a single device step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# f32 everywhere: a reduced-precision matmul (bf16 passes, or TF32 on a GPU)
# is far too coarse for registration at mse 1e-5 (see geo/procrustes.py).
_PREC = jax.lax.Precision.HIGHEST


def _register_dataclass(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda obj: ([getattr(obj, k) for k in fields], None),
        lambda _, children: cls(*children),
    )
    return cls


@_register_dataclass
@dataclasses.dataclass(frozen=True)
class RigidTransform:
    """A (batch of) rigid transform(s): ``y = R @ x + t``.

    ``R``: ``[..., 3, 3]``, ``t``: ``[..., 3]``.  Counterpart of the reference's
    ``(glm::mat3, glm::vec3)`` pairs threaded through every solver.
    """

    R: Any  # [..., 3, 3]
    t: Any  # [..., 3]

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "RigidTransform":
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
        t = jnp.zeros((*batch_shape, 3), dtype=dtype)
        return RigidTransform(R, t)

    def apply(self, points):
        """Transform points ``[..., N, 3]`` by this transform."""
        return (
            jnp.einsum("...ij,...nj->...ni", self.R, points, precision=_PREC) + self.t[..., None, :]
        )

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """Return ``self ∘ other`` (apply ``other`` first).

        Matches the update rule of the reference GPU ICP:
        ``R = R_ * R; t = R_ * t + t_`` (``src/fgoicp/icp3d.cu:99-100``).
        """
        R = jnp.einsum("...ij,...jk->...ik", self.R, other.R, precision=_PREC)
        t = jnp.einsum("...ij,...j->...i", self.R, other.t, precision=_PREC) + self.t
        return RigidTransform(R, t)

    def inverse(self) -> "RigidTransform":
        Rt = jnp.swapaxes(self.R, -1, -2)
        t = -jnp.einsum("...ij,...j->...i", Rt, self.t, precision=_PREC)
        return RigidTransform(Rt, t)

    @property
    def batch_shape(self):
        return self.t.shape[:-1]


@_register_dataclass
@dataclasses.dataclass(frozen=True)
class CubeBatch:
    """A batch of axis-aligned search cubes (structure-of-arrays).

    ``center``: ``[B, 3]`` cube centers (rotation-parameter space or R^3),
    ``span``: ``[B]`` half edge length (reference ``RotNode.span`` /
    ``TransNode.span`` semantics, ``src/common.h:80,113``),
    ``lb``/``ub``: ``[B]`` inherited bound values,
    ``mask``: ``[B]`` bool, False entries are padding (absent in the
    reference, required here because device steps have static shapes).
    """

    center: Any  # [B, 3]
    span: Any  # [B]
    lb: Any  # [B]
    ub: Any  # [B]
    mask: Any  # [B] bool

    @property
    def size(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def root(span: float = 1.0, ub: float = np.inf, dtype=np.float32) -> "CubeBatch":
        """Single root cube centered at origin (``fgoicp.cpp:35,119``)."""
        return CubeBatch(
            center=np.zeros((1, 3), dtype),
            span=np.full((1,), span, dtype),
            lb=np.zeros((1,), dtype),
            ub=np.full((1,), ub, dtype),
            mask=np.ones((1,), bool),
        )

    def subdivide(self) -> "CubeBatch":
        """8-way octant subdivision of every cube → batch of ``8*B``.

        Children are centered at ``center ± span/2`` with half the span,
        exactly the reference's child spawning (``fgoicp.cpp:53-60`` and
        ``fgoicp.cpp:160-173``); vectorized over the whole batch.
        Works on host numpy arrays (frontier management is host-side).
        """
        c, s = np.asarray(self.center), np.asarray(self.span)
        offs = np.array(
            [[(j >> 0 & 1), (j >> 1 & 1), (j >> 2 & 1)] for j in range(8)],
            dtype=c.dtype,
        ) * 2.0 - 1.0  # {-1, +1}^3
        half = s[:, None] / 2.0
        child_c = (c[:, None, :] + offs[None, :, :] * half[..., None]).reshape(-1, 3)
        child_s = np.repeat(s / 2.0, 8)
        rep = lambda x: np.repeat(np.asarray(x), 8)
        return CubeBatch(child_c, child_s, rep(self.lb), rep(self.ub), rep(self.mask))


@_register_dataclass
@dataclasses.dataclass(frozen=True)
class Bounds:
    """Lower/upper SSE bounds for a cube batch: each ``[B]``."""

    lb: Any
    ub: Any
