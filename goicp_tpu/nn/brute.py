"""Exact brute-force nearest neighbor as tiled dense XLA ops.

The reference's exact-NN paths are thread-per-query scalar loops over all
targets (``src/fgoicp/icp3d.cu:13-30``, ``src/icp_kernel.cu:105-119``,
``registration.cu:14-25``).  Here the same O(Q*Nt) work is a ``lax.scan``
over target tiles with a running (min, argmin).  The squared distance is
written per coordinate (no reduction over the size-3 axis), so XLA fuses
the whole difference-square-min chain of a tile into one reduction and the
``[Q, tile]`` pairs never reach device memory.

Used for: ICP correspondences, distance-grid construction (see
``goicp_tpu.nn.grid``), and as the *oracle* in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_INF = jnp.inf


def _pad_targets(targets, tile: int):
    """Pad ``[Nt,3]`` to a multiple of ``tile`` with +inf sentinels."""
    nt = targets.shape[0]
    pad = (-nt) % tile
    if pad:
        targets = jnp.concatenate(
            [targets, jnp.full((pad, 3), 1e30, targets.dtype)], axis=0
        )
    return targets, nt + pad


def _tile_d2(queries, t_tile):
    """``[..., Q, 3]`` × ``[tile, 3]`` → elementwise f32 ``[..., Q, tile]``."""
    dx = queries[..., :, 0:1] - t_tile[:, 0]
    dy = queries[..., :, 1:2] - t_tile[:, 1]
    dz = queries[..., :, 2:3] - t_tile[:, 2]
    return dx * dx + dy * dy + dz * dz


@functools.partial(jax.jit, static_argnames=("tile",))
def min_dist_sq(queries, targets, tile: int = 512):
    """Exact min squared distance from each query to the target set.

    ``queries``: ``[..., Q, 3]``; ``targets``: ``[Nt, 3]`` → ``[..., Q]``.
    Distances are computed elementwise in f32 (no |a|^2-2ab+|b|^2 matmul
    expansion: it loses ~3 digits to cancellation, which matters at
    mse thresholds of 1e-5, test/bunny_icp.toml:20).
    """
    targets, _ = _pad_targets(targets, tile)
    tiles = targets.reshape(-1, tile, 3)

    def body(best, t_tile):
        d2 = _tile_d2(queries, t_tile)  # [..., Q, tile]
        return jnp.minimum(best, jnp.min(d2, axis=-1)), None

    init = jnp.full(queries.shape[:-1], _INF, queries.dtype)
    best, _ = jax.lax.scan(body, init, tiles)
    return best


@functools.partial(jax.jit, static_argnames=("tile",))
def nearest_neighbor(queries, targets, tile: int = 512):
    """Exact NN: returns ``(dist_sq [..., Q], index [..., Q])``."""
    targets, _ = _pad_targets(targets, tile)
    tiles = targets.reshape(-1, tile, 3)

    def body(carry, xs):
        best, best_idx = carry
        i, t_tile = xs
        d2 = _tile_d2(queries, t_tile)
        arg = jnp.argmin(d2, axis=-1)
        val = jnp.min(d2, axis=-1)
        take = val < best
        best = jnp.where(take, val, best)
        best_idx = jnp.where(take, i * tile + arg, best_idx)
        return (best, best_idx), None

    init = (
        jnp.full(queries.shape[:-1], _INF, queries.dtype),
        jnp.zeros(queries.shape[:-1], jnp.int32),
    )
    idxs = jnp.arange(tiles.shape[0], dtype=jnp.int32)
    (best, best_idx), _ = jax.lax.scan(body, init, (idxs, tiles))
    return best, best_idx
