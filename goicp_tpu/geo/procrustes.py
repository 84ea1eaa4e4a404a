"""Batched 3x3 orthogonal Procrustes (the ICP pose update).

The reference solves this three different ways, all host-side and one pose at
a time: McAdams ``svd3.h`` (``src/icp_kernel.cu:28-46``), Eigen ``JacobiSVD``
(``src/fgoicp/icp3d.cu:110-138``), and the KIT matrix lib's Golub-Kahan SVD
(``src/goicp/matrix.cpp:602``), each followed by the determinant correction
``R = V diag(1,1,det(VU^T)) U^T``.

Batched replacement: **Horn's quaternion method**, fully batched and
device-resident.  The optimal rotation is the dominant eigenvector of a 4x4
symmetric matrix built from the cross-covariance — no SVD, no det correction
(the result is always a proper rotation), no host round-trip per iteration
(the reference pays a device→host hop for every SVD, SURVEY §3.5).  The 4x4
eigenvector is found with shifted power iteration (fixed count, jit-friendly);
``B`` poses solve simultaneously.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from goicp_tpu.geo.rotation import quat_to_matrix

# Small-K contractions must run in full f32 (no bf16 passes, no TF32):
# registration works at mse thresholds down to 1e-5 (test/bunny_icp.toml:20).
_PREC = jax.lax.Precision.HIGHEST


def _horn_K(C):
    """Horn's 4x4 symmetric matrix from cross-covariance ``C[...,3,3]``.

    ``C = sum_i a_i b_i^T`` for source points ``a`` and target points ``b``;
    the maximizing quaternion rotates ``a`` onto ``b``.
    """
    Sxx, Sxy, Sxz = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    Syx, Syy, Syz = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    Szx, Szy, Szz = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    row0 = jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1)
    row1 = jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1)
    row2 = jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1)
    row3 = jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1)
    return jnp.stack([row0, row1, row2, row3], axis=-2)


def horn_quaternion(C, squarings: int = 5, iters: int = 8):
    """Dominant eigen-quaternion of Horn's matrix, batched ``[...,3,3]→[...,4]``.

    ``K + 2|C|_F I`` is PSD with the same dominant eigenvector.  Repeated
    matrix squaring raises the spectral ratio to the ``2^squarings`` power
    (all 4x4 batched matmuls, no lax control flow), then a
    few power-iteration matvecs polish.  Degenerate inputs (``C = 0``) return
    the identity quaternion.
    """
    K = _horn_K(C)
    eye = jnp.eye(4, dtype=C.dtype)
    shift = 2.0 * jnp.linalg.norm(C, axis=(-2, -1), keepdims=True) + 1e-30
    Ks = (K + shift * eye) / shift  # scale ~O(1) to keep squarings stable
    for _ in range(squarings):
        Ks = jnp.einsum("...ij,...jk->...ik", Ks, Ks, precision=_PREC)
        Ks = Ks / jnp.maximum(
            jnp.linalg.norm(Ks, axis=(-2, -1), keepdims=True), 1e-30
        )
    # start from a fixed, generically non-orthogonal vector
    q = jnp.broadcast_to(
        jnp.array([1.0, 0.3, 0.2, 0.1], C.dtype), (*C.shape[:-2], 4)
    )

    def body(q, _):
        q = jnp.einsum("...ij,...j->...i", Ks, q, precision=_PREC)
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
        return q, None

    q, _ = jax.lax.scan(body, q, None, length=iters)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def procrustes(src, dst, weights=None, iters: int = 8):
    """Weighted least-squares rigid alignment, batched.

    ``src``/``dst``: ``[..., N, 3]``; ``weights``: optional ``[..., N]``
    (used for trimming: 0/1 inlier masks).  Returns ``(R, t)`` minimizing
    ``sum_i w_i |R src_i + t - dst_i|^2`` — the ``R = U^T V``/``t = mu_dst -
    R mu_src`` step of ``src/icp_kernel.cu:196-208`` and
    ``src/fgoicp/icp3d.cu:140-172``, without the host SVD.
    """
    if weights is None:
        w = jnp.ones(src.shape[:-1], src.dtype)
    else:
        w = weights
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-30)
    mu_s = jnp.sum(src * w[..., None], axis=-2) / wsum
    mu_d = jnp.sum(dst * w[..., None], axis=-2) / wsum
    a = src - mu_s[..., None, :]
    b = dst - mu_d[..., None, :]
    C = jnp.einsum("...ni,...nj->...ij", a * w[..., None], b, precision=_PREC)
    q = horn_quaternion(C, iters=iters)
    R = quat_to_matrix(q)
    t = mu_d - jnp.einsum("...ij,...j->...i", R, mu_s, precision=_PREC)
    return R, t
