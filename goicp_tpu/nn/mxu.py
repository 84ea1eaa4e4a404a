"""Fused bound kernels for the BnB hot path (Pallas, Triton route).

Three kernels, each standing in for an XLA pattern that either cannot
express the work, writes a large intermediate to device memory, or (the
per-point form) compiles for minutes on the GPU at solver batch sizes:

- :func:`bounds_nodes` — screened fused bounds for singleton SE(3) nodes.
  One program per node transforms the source cloud block by block, takes
  every point's exact min squared distance to the target cloud, and folds
  the Yang et al. eq. 10 deflation and the (ub, lb) sums into the same
  program.  The point-block loop stops as soon as the partial lower bound
  crosses the node's prune threshold (partial sums of nonnegative terms are
  valid lower bounds), a per-node data-dependent exit that a vmapped XLA
  ``lax.cond`` would turn into a select running both branches.  Nothing of
  shape ``[B, N]`` reaches device memory: the output is ``[B, 2]``.
- :func:`min_d2_groups` — exact min squared distances for groups of 8
  translation siblings sharing one rotation (an octant t-split).  With
  ``u = R·p`` and the base plane ``G[i,m] = |u_i − m|²``,

      |u_i + t_j − m|² = G[i,m] + 2·t_j·u_i + (|t_j|² − 2·t_j·m)

  so a program computes ``G`` once in registers and each sibling costs an
  add and a min per pair; ``2·t_j·u_i`` commutes with the min over ``m`` and
  joins after the target loop (≙ the reference's per-tnode reuse of a fixed
  rotation, ``registration.cu:88-151``).  XLA would either recompute the
  plane per sibling or materialize ``[8, N, M]``.
- :func:`min_d2_nodes` — the unfused per-point ``d² [B, N]`` of singleton
  nodes, for the epilogues the fused kernel does not cover (trimmed sums,
  point-sharded meshes).

Layout: a program owns one node (or group) and a power-of-two block of
``bn`` source points held in registers, and loops over target tiles of
``bm`` rows with an elementwise running minimum ``[bm, bn]``, so the
cross-row reduction happens once per point block.  Clouds are stored
coordinate-major (``[3, N]``) so every tile load is contiguous; padded
sources carry ``valid = 0`` and padded targets sit at an off-scale sentinel
that never wins a min.  Every pair costs ~9 f32 ops on the CUDA cores: K = 3
leaves the tensor cores nothing to do, and the certified bound's f32 error
model (``bnb.solver``'s ``_exact_slack``) rules out TF32.

The wrappers compile the kernels only where
:func:`goicp_tpu.core.device.kernel_route` names a route; elsewhere they
raise unless the caller passes ``interpret=True`` (the CPU tests run the
kernels in the Pallas interpreter that way).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from goicp_tpu.core.device import kernel_route

_PAD_TGT = 1e15     # padded targets: off-scale, never the nearest
BN = 128            # source points per program block (registers)
BM = 32             # target rows per inner tile, singleton bounds kernel
GBM = 8             # target rows per inner tile, grouped kernel (8 minima)
NUM_WARPS = 4
NUM_STAGES = 2
_SCREENED_UB = 1e30  # ub sentinel of a node whose partial lb crossed thresh


def _check_route(interpret: bool) -> None:
    if kernel_route() is None and not interpret:
        raise RuntimeError(
            "the fused bound kernels have no compiled route on platform "
            f"{jax.devices()[0].platform!r} (they need a GPU); pass "
            "interpret=True to run them in the Pallas interpreter"
        )


def _pad_cols(x, quantum: int, value: float):
    pad = (-x.shape[1]) % quantum
    if not pad:
        return x
    return jnp.pad(x, ((0, 0), (0, pad)), constant_values=value)


def pack_sources(src, norms=None, *, bn: int = BN):
    """``[N,3] → [3, Np]`` rows (x, y, z), or with ``norms [N]`` → ``[5, Np]``
    rows (x, y, z, ‖p‖, valid); zero-padded (valid = 0) to a multiple of
    ``bn``."""
    src = jnp.asarray(src, jnp.float32)
    rows = src.T
    if norms is not None:
        n = src.shape[0]
        rows = jnp.concatenate(
            [rows, jnp.asarray(norms, jnp.float32).reshape(1, n),
             jnp.ones((1, n), jnp.float32)]
        )
    return _pad_cols(rows, bn, 0.0)


def pack_targets(tgt, *, bm: int = BM):
    """``[Nt,3] → [3, Mp]`` rows (x, y, z), padded to a multiple of ``bm``
    with off-scale sentinels."""
    return _pad_cols(jnp.asarray(tgt, jnp.float32).T, bm, _PAD_TGT)


def pack_params_bounds(R, t, af, gt, slack, thresh):
    """``[B,16]`` rows (R×9, t×3, af, γt, slack, thresh) for
    :func:`bounds_nodes`: ``af = 2·sin(min(θ, π)/2)`` scales the per-point
    rotation radius ``af·‖p‖``, ``γt`` is the translation corner radius."""
    R = jnp.asarray(R, jnp.float32)
    B = R.shape[0]
    col = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), (B,))[:, None]
    return jnp.concatenate(
        [R.reshape(B, 9), jnp.asarray(t, jnp.float32), col(af), col(gt),
         col(slack), col(thresh)],
        axis=1,
    )


def pack_group_params(R, t8):
    """``R [G,3,3], t8 [G,8,3] → [G,48]`` rows (R×9, t8×24, |t_j|²×8, pad)
    for :func:`min_d2_groups`."""
    R = jnp.asarray(R, jnp.float32)
    t8 = jnp.asarray(t8, jnp.float32)
    G = R.shape[0]
    return jnp.concatenate(
        [R.reshape(G, 9), t8.reshape(G, 24), jnp.sum(t8 * t8, axis=-1),
         jnp.zeros((G, 7), jnp.float32)],
        axis=1,
    )


def _tile_min(tgt_ref, c, bm, best, qx, qy, qz):
    """Fold target rows ``[c·bm, (c+1)·bm)`` into the elementwise running
    minimum ``best [bm, bn]`` of squared distances to queries ``q [bn]``."""
    rows = pl.ds(c * bm, bm)
    dx = tgt_ref[0, rows][:, None] - qx[None, :]
    dy = tgt_ref[1, rows][:, None] - qy[None, :]
    dz = tgt_ref[2, rows][:, None] - qz[None, :]
    return jnp.minimum(best, dx * dx + dy * dy + dz * dz)


def _bounds_kernel(params_ref, src_ref, tgt_ref, out_ref, *,
                   nb: int, nc: int, bn: int, bm: int):
    """One program per node: fused, screened (ub, lb) of node ``b``."""
    b = pl.program_id(0)
    r = [params_ref[b, k] for k in range(16)]
    af, gt, slack, thresh = r[12], r[13], r[14], r[15]

    def block(carry):
        n, ub, lb = carry
        cols = pl.ds(n * bn, bn)
        px, py, pz = src_ref[0, cols], src_ref[1, cols], src_ref[2, cols]
        qx = px * r[0] + py * r[1] + pz * r[2] + r[9]
        qy = px * r[3] + py * r[4] + pz * r[5] + r[10]
        qz = px * r[6] + py * r[7] + pz * r[8] + r[11]
        best = jax.lax.fori_loop(
            0, nc,
            lambda c, acc: _tile_min(tgt_ref, c, bm, acc, qx, qy, qz),
            jnp.full((bm, bn), jnp.inf, jnp.float32),
        )
        d = jnp.sqrt(jnp.maximum(jnp.min(best, axis=0), 0.0))
        d_hi = d + slack
        defl = af * src_ref[3, cols] + gt
        lo = jnp.maximum(jnp.maximum(d - slack, 0.0) - defl, 0.0)
        pv = src_ref[4, cols]
        return (n + 1, ub + jnp.sum(d_hi * d_hi * pv),
                lb + jnp.sum(lo * lo * pv))

    _, ub, lb = jax.lax.while_loop(
        lambda c: (c[0] < nb) & (c[2] < thresh),
        block,
        (jnp.int32(0), jnp.float32(0.0), jnp.float32(0.0)),
    )
    # lb ≥ thresh ⇒ the node is dead under the ε-rule; its ub (partial when
    # the loop stopped early) is replaced by a sentinel that can never
    # become an incumbent
    out_ref[b, 0] = jnp.where(lb < thresh, ub, _SCREENED_UB)
    out_ref[b, 1] = lb


@functools.partial(
    jax.jit,
    static_argnames=("interpret", "bn", "bm", "num_warps", "num_stages"),
)
def bounds_nodes(src, norms, tgt, params, *, interpret: bool = False,
                 bn: int = BN, bm: int = BM, num_warps: int = NUM_WARPS,
                 num_stages: int = NUM_STAGES):
    """Fused screened bounds for singleton nodes.

    ``src [N,3]``, ``norms [N]``, ``tgt [Nt,3]``, ``params [B,16]``
    (:func:`pack_params_bounds`) → ``(ub, lb) [B]``.  A node whose partial
    lower bound reaches its threshold stops early and reports
    ``(1e30, partial lb ≥ thresh)``; the others report the full sums."""
    _check_route(interpret)
    srcT = pack_sources(src, norms, bn=bn)
    tgtT = pack_targets(tgt, bm=bm)
    B = params.shape[0]
    out = pl.pallas_call(
        functools.partial(
            _bounds_kernel, nb=srcT.shape[1] // bn, nc=tgtT.shape[1] // bm,
            bn=bn, bm=bm,
        ),
        grid=(B,),
        out_shape=jax.ShapeDtypeStruct((B, 2), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="goicp_bounds_nodes",
    )(jnp.asarray(params, jnp.float32), srcT, tgtT)
    return out[:, 0], out[:, 1]


def _min_d2_kernel(params_ref, src_ref, tgt_ref, out_ref, *,
                   nc: int, bn: int, bm: int):
    """One program per (node b, point block n): exact min squared distances
    of ``bn`` transformed source points."""
    b = pl.program_id(0)
    cols = pl.ds(pl.program_id(1) * bn, bn)
    r = [params_ref[b, k] for k in range(12)]
    px, py, pz = src_ref[0, cols], src_ref[1, cols], src_ref[2, cols]
    qx = px * r[0] + py * r[1] + pz * r[2] + r[9]
    qy = px * r[3] + py * r[4] + pz * r[5] + r[10]
    qz = px * r[6] + py * r[7] + pz * r[8] + r[11]
    best = jax.lax.fori_loop(
        0, nc,
        lambda c, acc: _tile_min(tgt_ref, c, bm, acc, qx, qy, qz),
        jnp.full((bm, bn), jnp.inf, jnp.float32),
    )
    out_ref[0, :] = jnp.min(best, axis=0)


@functools.partial(
    jax.jit,
    static_argnames=("interpret", "bn", "bm", "num_warps", "num_stages"),
)
def min_d2_nodes(src, tgt, R, t, *, interpret: bool = False, bn: int = BN,
                 bm: int = BM, num_warps: int = NUM_WARPS,
                 num_stages: int = NUM_STAGES):
    """Exact per-point min squared distances of singleton nodes.

    ``src [N,3]``, ``tgt [Nt,3]``, ``R [B,3,3]``, ``t [B,3]`` →
    ``d2 [B, Np]`` for queries ``R_b·p + t_b`` (``Np`` = N padded to
    ``bn``; padded columns are garbage for the caller to mask).  The
    unfused form of :func:`bounds_nodes`, for epilogues the fused kernel
    does not cover (trimmed sums, point-sharded meshes)."""
    _check_route(interpret)
    srcT = pack_sources(src, bn=bn)
    tgtT = pack_targets(tgt, bm=bm)
    B, Np = R.shape[0], srcT.shape[1]
    params = jnp.concatenate(
        [jnp.asarray(R, jnp.float32).reshape(B, 9),
         jnp.asarray(t, jnp.float32)], axis=1,
    )
    return pl.pallas_call(
        functools.partial(_min_d2_kernel, nc=tgtT.shape[1] // bm, bn=bn,
                          bm=bm),
        grid=(B, Np // bn),
        out_specs=pl.BlockSpec((1, bn), lambda b, n: (b, n)),
        out_shape=jax.ShapeDtypeStruct((B, Np), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="goicp_min_d2_nodes",
    )(params, srcT, tgtT)


def _min_d2_grouped_kernel(params_ref, src_ref, tgt_ref, out_ref, *,
                           nc: int, bn: int, bm: int):
    """One program per (group g, point block n): the 8 siblings' exact min
    squared distances for ``bn`` source points."""
    g = pl.program_id(0)
    cols = pl.ds(pl.program_id(1) * bn, bn)
    r = [params_ref[g, k] for k in range(41)]
    px, py, pz = src_ref[0, cols], src_ref[1, cols], src_ref[2, cols]
    ux = px * r[0] + py * r[1] + pz * r[2]
    uy = px * r[3] + py * r[4] + pz * r[5]
    uz = px * r[6] + py * r[7] + pz * r[8]
    ts = [(r[9 + 3 * j], r[10 + 3 * j], r[11 + 3 * j], r[33 + j])
          for j in range(8)]

    def tile(c, best):
        rows = pl.ds(c * bm, bm)
        mx, my, mz = tgt_ref[0, rows], tgt_ref[1, rows], tgt_ref[2, rows]
        dx = mx[:, None] - ux[None, :]
        dy = my[:, None] - uy[None, :]
        dz = mz[:, None] - uz[None, :]
        plane = dx * dx + dy * dy + dz * dz               # base plane, once
        return tuple(
            jnp.minimum(
                best[j],
                plane + (tn - 2.0 * (tx * mx + ty * my + tz * mz))[:, None],
            )
            for j, (tx, ty, tz, tn) in enumerate(ts)
        )

    best = jax.lax.fori_loop(
        0, nc, tile,
        tuple(jnp.full((bm, bn), jnp.inf, jnp.float32) for _ in range(8)),
    )
    for j, (tx, ty, tz, _) in enumerate(ts):
        a = 2.0 * (tx * ux + ty * uy + tz * uz)
        out_ref[j, :] = jnp.maximum(jnp.min(best[j], axis=0) + a, 0.0)


@functools.partial(
    jax.jit,
    static_argnames=("interpret", "bn", "bm", "num_warps", "num_stages"),
)
def min_d2_groups(src, tgt, gparams, *, interpret: bool = False,
                  bn: int = BN, bm: int = GBM, num_warps: int = NUM_WARPS,
                  num_stages: int = NUM_STAGES):
    """Exact min squared distances for 8-sibling translation groups.

    ``src [N,3]``, ``tgt [Nt,3]``, ``gparams [G,48]``
    (:func:`pack_group_params`) → ``d2 [8·G, Np]`` (``Np`` = N padded to
    ``bn``; padded columns are garbage for the caller to mask), row
    ``8g+j`` = node ``(R_g, t_{g,j})``."""
    _check_route(interpret)
    srcT = pack_sources(src, bn=bn)
    tgtT = pack_targets(tgt, bm=bm)
    G, Np = gparams.shape[0], srcT.shape[1]
    return pl.pallas_call(
        functools.partial(
            _min_d2_grouped_kernel, nc=tgtT.shape[1] // bm, bn=bn, bm=bm
        ),
        grid=(G, Np // bn),
        out_specs=pl.BlockSpec((8, bn), lambda g, n: (g, n)),
        out_shape=jax.ShapeDtypeStruct((8 * G, Np), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="goicp_min_d2_groups",
    )(jnp.asarray(gparams, jnp.float32), srcT, tgtT)
