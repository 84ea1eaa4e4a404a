"""Surface-normal estimation for point clouds (PCA over k nearest neighbors).

The reference has no normals anywhere — its ICP is point-to-point only
(``src/fgoicp/icp3d.cu:140-172``, ``src/goicp/jly_icp3d.hpp:181-297``).
Normals enable the point-to-plane metric in :mod:`goicp_tpu.icp.solver`,
which converges in far fewer iterations on real scan data (Chen & Medioni
1991); this is a capability upgrade, not a port.

Design: the k-NN search is the same tiled dense pattern as
:mod:`goicp_tpu.nn.brute` (no trees; one ``[block, N]`` distance tile per
query block), and the smallest eigenvector
of each 3x3 neighborhood covariance is closed-form (trigonometric
eigenvalues + cross-product eigenvector), so the whole estimate is one jit
with no host round-trips and no ``eigh`` lowering.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _smallest_eigvec_3x3(C):
    """Unit eigenvector of the smallest eigenvalue of symmetric ``[...,3,3]``.

    Eigenvalues via the trigonometric closed form (Smith 1961); the
    eigenvector is the largest cross product of two rows of ``C - lmin*I``
    (rows of a rank-2 matrix span the plane orthogonal to the eigenvector).
    Degenerate (isotropic) neighborhoods fall back to +z.
    """
    q = jnp.trace(C, axis1=-2, axis2=-1)[..., None, None] / 3.0
    A = C - q * jnp.eye(3, dtype=C.dtype)
    p2 = jnp.sum(A * A, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 0.0))
    ps = jnp.maximum(p, 1e-30)[..., None, None]
    B = A / ps
    detB = jnp.linalg.det(B)
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # lmin = q + 2p*cos(phi + 2*pi/3)
    lmin = q[..., 0, 0] + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    M = C - lmin[..., None, None] * jnp.eye(3, dtype=C.dtype)
    c01 = jnp.cross(M[..., 0, :], M[..., 1, :])
    c02 = jnp.cross(M[..., 0, :], M[..., 2, :])
    c12 = jnp.cross(M[..., 1, :], M[..., 2, :])
    cands = jnp.stack([c01, c02, c12], axis=-2)              # [...,3,3]
    n2 = jnp.sum(cands * cands, axis=-1)                     # [...,3]
    best = jnp.argmax(n2, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    vn2 = jnp.sum(v * v, axis=-1, keepdims=True)

    # rank-1 M (lmin has multiplicity 2 — e.g. collinear neighborhoods):
    # all row cross products vanish; any unit vector orthogonal to the
    # largest row is a valid eigenvector.  cross the row with the axis it
    # is LEAST aligned with for a well-conditioned result.
    rn2 = jnp.sum(M * M, axis=-1)
    row = jnp.take_along_axis(
        M, jnp.argmax(rn2, axis=-1)[..., None, None], axis=-2
    )[..., 0, :]
    axis = jax.nn.one_hot(
        jnp.argmin(jnp.abs(row), axis=-1), 3, dtype=C.dtype
    )
    v2 = jnp.cross(row, axis)
    v2n2 = jnp.sum(v2 * v2, axis=-1, keepdims=True)

    # rank-0 M (isotropic: every direction is an eigenvector): fixed +z
    fallback = jnp.zeros_like(v).at[..., 2].set(1.0)
    v2 = jnp.where(
        v2n2 > 1e-18, v2 / jnp.sqrt(jnp.maximum(v2n2, 1e-30)), fallback
    )
    # relative tolerance: cross-product magnitudes scale with |M|^2
    scale2 = jnp.maximum(jnp.sum(rn2, axis=-1, keepdims=True) ** 2, 1e-30)
    v = jnp.where(
        vn2 > 1e-12 * scale2, v / jnp.sqrt(jnp.maximum(vn2, 1e-30)), v2
    )
    return v


@functools.partial(jax.jit, static_argnames=("k", "block"))
def estimate_normals(points, k: int = 16, block: int = 1024):
    """PCA normals of ``points [N,3]`` from each point's ``k`` nearest
    neighbors (the point itself included).  Returns unit normals ``[N,3]``.

    Orientation is arbitrary (sign-ambiguous) — the point-to-plane metric
    squares the residual, so no consistent orientation pass is needed.
    Blocked over queries: each block materializes a ``[block, N]`` distance
    tile, selects k neighbors with an exact ``top_k``, and reduces the 3x3
    covariance; nothing of O(N^2) is materialized at once.
    """
    pts = jnp.asarray(points, jnp.float32)
    n = pts.shape[0]
    kk = min(k, n)
    pad = (-n) % block
    q = jnp.concatenate([pts, jnp.zeros((pad, 3), jnp.float32)], axis=0)
    q = q.reshape(-1, block, 3)

    def one_block(qb):
        d2 = (
            jnp.sum(qb * qb, axis=-1)[:, None]
            - 2.0 * jnp.matmul(qb, pts.T,
                               precision=jax.lax.Precision.HIGHEST)
            + jnp.sum(pts * pts, axis=-1)[None, :]
        )                                                    # [block, N]
        _, idx = jax.lax.top_k(-d2, kk)                      # [block, kk]
        nbr = pts[idx]                                       # [block, kk, 3]
        mu = jnp.mean(nbr, axis=1, keepdims=True)
        d = nbr - mu
        C = jnp.einsum("bki,bkj->bij", d, d,
                       precision=jax.lax.Precision.HIGHEST) / kk
        return _smallest_eigvec_3x3(C)

    out = jax.lax.map(one_block, q)                          # [nb, block, 3]
    return out.reshape(-1, 3)[:n]
