"""Jitted batched ICP — the local refiner of every solver mode.

Reference counterparts, all of which refine **one** pose at a time with a
host SVD round-trip per iteration:

- per-frame steps ``ICP::CPUStep/naiveGPUStep/kdTreeGPUStep``
  (``src/icp_kernel.cu:48-279``),
- the GPU BnB's ``IterativeClosestPoint3D::run`` (``src/fgoicp/icp3d.cu:83-108``),
- the CPU BnB's ``ICP3D<T>::Run`` (``src/goicp/jly_icp3d.hpp:181-297``).

Batched inversion: one ``lax.while_loop`` refines a **batch** ``[B]`` of
poses simultaneously (the BnB refines every promising cube in one device
step, SURVEY §7.5); the Procrustes update is Horn's quaternion method
(``goicp_tpu.geo.procrustes``) so no iteration ever leaves the device.
Correspondences come from either the exact tiled brute-force NN
(≙ ``kernFindNearestNeighbor``, ``icp3d.cu:13-30``) or the distance-grid
index field (≙ the flattened k-d tree of ``icp_kernel.cu:281-377``, which the
reference found slower than dense lookups on GPU).

Trimming: per-pose ``top_k`` selection of the ``n*(1-trim)`` closest pairs
(≙ the qsort at ``jly_icp3d.hpp:238`` / ``intro_select``), as 0/1 weights
into the weighted Procrustes.

Metrics: ``IcpParams.metric`` selects ``"point"`` (the reference's
point-to-point Procrustes — the only metric the reference has) or
``"plane"`` (point-to-plane, Chen & Medioni 1991: damped Gauss-Newton on
the 6-DoF twist, converging in far fewer iterations on smooth scan
geometry).  Plane mode needs target normals — pass ``normals=`` to the
correspondence factories (:func:`goicp_tpu.geo.normals.estimate_normals`).
Reported/best-tracked SSE stays the point-to-point (trimmed) SSE in both
modes, so callers' convergence contracts (mse thresholds, BnB incumbents)
are metric-independent; only the descent direction and the convergence
gate change.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp

from goicp_tpu.core.types import RigidTransform
from goicp_tpu.geo.procrustes import procrustes
from goicp_tpu.nn.brute import nearest_neighbor
from goicp_tpu.nn.grid import DistanceGrid, lookup_index


@dataclasses.dataclass(frozen=True)
class IcpParams:
    """Static solver knobs (hashable: closed over at trace time)."""

    max_iter: int = 128          # ref: 1000 initial / 500 refine (fgoicp.cpp:11,77)
    rel_tol: float = 1e-3        # ref convergence_threshold (icp3d.cu:95)
    trim_fraction: float = 0.0   # ref trimFraction (jly_icp3d.hpp:189-196)
    metric: str = "point"        # "point" (ref parity) | "plane" (upgrade)


@dataclasses.dataclass(frozen=True)
class IcpResult:
    transform: RigidTransform  # [B,3,3], [B,3]
    sse: Any                   # [B]
    iters: Any                 # [B] int32 iterations actually run


jax.tree_util.register_pytree_node(
    IcpResult,
    lambda r: ((r.transform, r.sse, r.iters), None),
    lambda _, c: IcpResult(*c),
)


def exact_correspondence(targets, normals=None) -> Callable:
    """Correspondence closure: exact brute-force NN against ``targets [Nt,3]``
    (``nn.brute.nearest_neighbor``, elementwise f32).

    With ``normals [Nt,3]`` the closure returns ``(dst, nrm, d2)`` (the
    plane-metric contract); without, ``(dst, d2)``."""
    targets = jnp.asarray(targets, jnp.float32)
    nrms = None if normals is None else jnp.asarray(normals, jnp.float32)

    def corr(pts):
        d2, idx = nearest_neighbor(pts, targets)
        dst = jnp.take(targets, idx, axis=0)
        if nrms is None:
            return dst, d2
        return dst, jnp.take(nrms, idx, axis=0), d2

    return corr


def grid_correspondence(grid: DistanceGrid, targets, normals=None) -> Callable:
    """Correspondence closure: O(1) grid index lookup (needs ``with_index``).

    With ``normals [Nt,3]`` returns ``(dst, nrm, d2)`` per query."""
    targets = jnp.asarray(targets, jnp.float32)
    nrms = None if normals is None else jnp.asarray(normals, jnp.float32)

    def corr(pts):
        idx = lookup_index(grid, pts)
        dst = jnp.take(targets, idx, axis=0)
        d = pts - dst
        d2 = jnp.sum(d * d, axis=-1)
        if nrms is None:
            return dst, d2
        return dst, jnp.take(nrms, idx, axis=0), d2

    return corr


def _split_corr(out):
    """Normalize a correspondence result to ``(dst, nrm_or_None, d2)``."""
    if len(out) == 3:
        return out
    dst, d2 = out
    return dst, None, d2


def _plane_update(pts, dst, nrm, w):
    """One damped Gauss-Newton step of the point-to-plane metric.

    Minimizes ``sum_i w_i ((R pts_i + t - dst_i) . nrm_i)^2`` linearized at
    identity (small-angle twist ``x = (omega, t)``); returns ``(R_d, t_d)``
    to be composed ON TOP of the current transform — the same contract as
    :func:`goicp_tpu.geo.procrustes.procrustes`.  Tikhonov damping
    (1e-6 * mean diag) keeps rank-deficient systems (planar targets leave
    3 in-plane DoF unconstrained) finite; the undamped solution is
    recovered to f32 accuracy on well-conditioned systems.

    Shapes: ``pts/dst/nrm [...,N,3]``, ``w [...,N]`` or None.
    """
    from goicp_tpu.geo.rotation import axis_angle_rotation

    r = jnp.sum((pts - dst) * nrm, axis=-1)                  # [...,N]
    a = jnp.cross(pts, nrm)                                  # [...,N,3]
    J = jnp.concatenate([a, nrm], axis=-1)                   # [...,N,6]
    Jw = J if w is None else J * w[..., None]
    hp = jax.lax.Precision.HIGHEST  # full f32: no reduced-precision passes
    H = jnp.einsum("...ni,...nj->...ij", Jw, J, precision=hp)  # [...,6,6]
    g = jnp.einsum("...ni,...n->...i", Jw, r, precision=hp)    # [...,6]
    damp = 1e-6 * (jnp.trace(H, axis1=-2, axis2=-1) / 6.0 + 1e-12)
    Hd = H + damp[..., None, None] * jnp.eye(6, dtype=H.dtype)
    x = -jnp.linalg.solve(Hd, g[..., None])[..., 0]          # [...,6]
    R_d = axis_angle_rotation(x[..., :3])
    return R_d, x[..., 3:]


def trim_weights(d2, trim_fraction: float):
    """0/1 inlier weights keeping the ``n*(1-trim)`` closest pairs per pose.

    ``d2``: ``[..., N]``.  The threshold is the k-th smallest distance
    (``jly_icp3d.hpp:189-196,238`` keeps ``n(1-trim)`` closest).
    """
    n = d2.shape[-1]
    k = max(1, int(round(n * (1.0 - trim_fraction))))
    if k >= n:
        return jnp.ones_like(d2)
    kth = -jax.lax.top_k(-d2, k)[0][..., -1:]
    w = (d2 <= kth).astype(d2.dtype)
    # Ties at the threshold can admit >k points; harmless for LS weighting.
    return w


def sse_of_distances(d2, trim_fraction: float = 0.0):
    """(Trimmed) SSE from per-point squared distances ``[..., N]``."""
    if trim_fraction > 0.0:
        w = trim_weights(d2, trim_fraction)
        return jnp.sum(d2 * w, axis=-1)
    return jnp.sum(d2, axis=-1)


def run_icp(
    src,
    corr: Callable,
    init: RigidTransform,
    params: IcpParams = IcpParams(),
    point_weights=None,
    active0=None,
) -> IcpResult:
    """Refine a batch of poses with ICP until convergence or ``max_iter``.

    ``src``: ``[N,3]`` source cloud; ``init``: batched ``[B]`` transforms;
    ``corr(pts [...,N,3]) -> (dst [...,N,3], d2 [...,N])``;
    ``point_weights``: optional ``[N]`` (or broadcastable) per-point weights
    — 0 entries are excluded from both the Procrustes solve and the SSE
    (used for padded clouds in multi-pair batching).
    ``active0``: optional ``[B]`` bool — poses starting False are never
    iterated and report ``sse=inf``/``iters=0`` (the BnB round tail's
    ``ub < refine_factor·best`` gate, ≙ the relaxed ICP trigger
    ``fgoicp.cpp:75``; when ALL poses are inactive the while_loop exits on
    its first condition check, so a fully-gated round pays ~nothing).

    Per-pose convergence: relative SSE improvement below ``rel_tol``
    (≙ ``icp3d.cu:95``: ``last_sse - sse < tol * sse``); converged poses stop
    updating (masked), the loop ends when all poses converge.
    """
    src = jnp.asarray(src, jnp.float32)
    batched = init.t.ndim > 1
    T0 = init if batched else jax.tree.map(lambda x: x[None], init)
    B = T0.t.shape[0]
    tf = params.trim_fraction
    plane = params.metric == "plane"
    if params.metric not in ("point", "plane"):
        raise ValueError(f"unknown IcpParams.metric {params.metric!r}")
    pw = None if point_weights is None else jnp.asarray(point_weights, jnp.float32)

    def _weights(d2):
        if pw is None:
            return trim_weights(d2, tf) if tf > 0.0 else None
        if tf <= 0.0:
            return jnp.broadcast_to(pw, d2.shape)
        # padded points (weight 0) must neither occupy inlier slots nor
        # count toward the inlier quota: mask them to +inf and derive k
        # from the EFFECTIVE point count
        masked = jnp.where(pw > 0, d2, jnp.inf)
        cnt = jnp.sum((pw > 0).astype(jnp.float32), axis=-1)
        k = jnp.maximum(jnp.round(cnt * (1.0 - tf)).astype(jnp.int32), 1)
        srt = jnp.sort(masked, axis=-1)
        idx = jnp.broadcast_to(k - 1, masked.shape[:-1])[..., None]
        kth = jnp.take_along_axis(srt, idx, axis=-1)
        return (masked <= kth).astype(d2.dtype) * pw

    def _sse_from(d2, w):
        if w is None:
            return jnp.sum(d2, axis=-1)
        return jnp.sum(d2 * w, axis=-1)

    if params.max_iter == 0:
        # pure scoring: one correspondence pass, no refinement
        dst, _, d2 = _split_corr(corr(T0.apply(src)))
        sse0 = _sse_from(d2, _weights(d2))
        T, iters = T0, jnp.zeros((B,), jnp.int32)
        if not batched:
            T = jax.tree.map(lambda x: x[0], T)
            sse0, iters = sse0[0], iters[0]
        return IcpResult(transform=T, sse=sse0, iters=iters)

    def cond(state):
        active, it = state[4], state[5]
        return jnp.logical_and(jnp.any(active), it < params.max_iter)

    def body(state):
        # ONE correspondence search per iteration: it scores the pose being
        # visited AND supplies the Procrustes system for the next step (the
        # previous version ran a second full NN pass just to score T_new,
        # doubling the dominant cost of every ICP call).
        T_best, sse_best, gate_best, T_cur, active, it, iters = state
        pts = T_cur.apply(src)  # [B,N,3]
        dst, nrm, d2 = _split_corr(corr(pts))
        w = _weights(d2)
        sse_cur = _sse_from(d2, w)
        if plane:
            if nrm is None:
                raise ValueError(
                    "metric='plane' needs a correspondence closure built "
                    "with normals= (see exact_correspondence/"
                    "grid_correspondence)"
                )
            r = jnp.sum((pts - dst) * nrm, axis=-1)
            gate_cur = _sse_from(r * r, w)  # plane SSE gates convergence
        else:
            gate_cur = sse_cur

        take = jnp.logical_and(active, sse_cur < sse_best)
        T_best = jax.tree.map(
            lambda new, old: jnp.where(
                take.reshape((B,) + (1,) * (new.ndim - 1)), new, old
            ),
            T_cur,
            T_best,
        )
        # converged: relative improvement of the gate metric below tol
        # (or no improvement); the gate is the point SSE for metric="point"
        # (unchanged reference semantics) and the plane SSE for "plane"
        # (plane steps may transiently raise the point SSE while still
        # descending the plane objective)
        still = jnp.logical_and(
            active,
            gate_best - gate_cur
            >= params.rel_tol * jnp.maximum(gate_cur, 1e-30),
        )
        sse_best = jnp.where(take, sse_cur, sse_best)
        gate_best = jnp.where(
            jnp.logical_and(active, gate_cur < gate_best), gate_cur, gate_best
        )

        if plane:
            R_d, t_d = _plane_update(pts, dst, nrm, w)
        else:
            R_d, t_d = procrustes(pts, dst, weights=w)
        T_next = RigidTransform(R_d, t_d).compose(T_cur)  # ≙ icp3d.cu:99-100
        T_cur = jax.tree.map(
            lambda new, old: jnp.where(
                still.reshape((B,) + (1,) * (new.ndim - 1)), new, old
            ),
            T_next,
            T_cur,
        )
        iters = iters + active.astype(jnp.int32)
        return T_best, sse_best, gate_best, T_cur, still, it + 1, iters

    act0 = (
        jnp.ones((B,), bool)
        if active0 is None
        else jnp.broadcast_to(jnp.asarray(active0, bool), (B,))
    )
    state = (
        T0,
        jnp.full((B,), jnp.inf, jnp.float32),
        jnp.full((B,), jnp.inf, jnp.float32),
        T0,
        act0,
        jnp.asarray(0, jnp.int32),
        jnp.zeros((B,), jnp.int32),
    )
    T, sse, _, _, _, _, iters = jax.lax.while_loop(cond, body, state)
    if not batched:
        T = jax.tree.map(lambda x: x[0], T)
        sse, iters = sse[0], iters[0]
    return IcpResult(transform=T, sse=sse, iters=iters)


def run_icp_trace(
    src,
    corr: Callable,
    init: RigidTransform,
    params: IcpParams = IcpParams(),
):
    """Like :func:`run_icp` but RECORDS the visited pose and SSE at every
    iteration — the artifact-producing form of the reference's per-frame
    ICP modes (one iteration per rendered frame, ``main.cpp:99-141``).

    Single (unbatched) pose.  Returns ``(IcpResult, trace)`` where
    ``trace = (R [T,3,3], t [T,3], sse [T], active [T])`` over a fixed
    ``max_iter`` scan; after convergence the remaining steps take a cheap
    frozen branch (no correspondence search), so the early-stop economy of
    the while_loop form is preserved and ``active`` marks the real steps.
    """
    src = jnp.asarray(src, jnp.float32)
    tf = params.trim_fraction
    plane = params.metric == "plane"
    if params.metric not in ("point", "plane"):
        raise ValueError(f"unknown IcpParams.metric {params.metric!r}")

    def _w(d2):
        return trim_weights(d2, tf) if tf > 0.0 else None

    def _sse(d2, w):
        return jnp.sum(d2 if w is None else d2 * w, axis=-1)

    def step(state, _):
        T_best, sse_best, gate_best, T_cur, active = state

        def live(_):
            pts = T_cur.apply(src)
            dst, nrm, d2 = _split_corr(corr(pts))
            w = _w(d2)
            sse_cur = _sse(d2, w)
            if plane:
                if nrm is None:
                    raise ValueError(
                        "metric='plane' needs a correspondence closure "
                        "built with normals= (see exact_correspondence/"
                        "grid_correspondence)"
                    )
                rr = jnp.sum((pts - dst) * nrm, axis=-1)
                gate_cur = _sse(rr * rr, w)
            else:
                gate_cur = sse_cur
            take = sse_cur < sse_best
            T_b = jax.tree.map(
                lambda new, old: jnp.where(take, new, old), T_cur, T_best
            )
            sse_b = jnp.where(take, sse_cur, sse_best)
            still = (
                gate_best - gate_cur
                >= params.rel_tol * jnp.maximum(gate_cur, 1e-30)
            )
            gate_b = jnp.minimum(gate_best, gate_cur)
            if plane:
                R_d, t_d = _plane_update(pts, dst, nrm, w)
            else:
                R_d, t_d = procrustes(pts, dst, weights=w)
            T_next = RigidTransform(R_d, t_d).compose(T_cur)
            T_n = jax.tree.map(
                lambda new, old: jnp.where(still, new, old), T_next, T_cur
            )
            return T_b, sse_b, gate_b, T_n, still, sse_cur

        def frozen(_):
            return T_best, sse_best, gate_best, T_cur, active, sse_best

        T_b, sse_b, gate_b, T_n, still, sse_cur = jax.lax.cond(
            active, live, frozen, operand=None
        )
        ys = (T_cur.R, T_cur.t, sse_cur, active)
        return (T_b, sse_b, gate_b, T_n, still), ys

    if params.max_iter == 0:
        # pure scoring — the same contract as run_icp(max_iter=0): one
        # correspondence pass, no refinement step, iters=0
        dst0, _, d20 = _split_corr(corr(init.apply(src)))
        sse0 = _sse(d20, _w(d20))
        trace = (
            init.R[None], init.t[None], sse0[None],
            jnp.asarray([False]),
        )
        return IcpResult(transform=init, sse=sse0, iters=jnp.int32(0)), trace

    state = (
        init, jnp.float32(jnp.inf), jnp.float32(jnp.inf), init,
        jnp.asarray(True),
    )
    (T, sse, _, _, _), trace = jax.lax.scan(
        step, state, None, length=max(params.max_iter, 1)
    )
    iters = jnp.sum(trace[3].astype(jnp.int32))
    return IcpResult(transform=T, sse=sse, iters=iters), trace
