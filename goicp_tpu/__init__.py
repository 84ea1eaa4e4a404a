"""goicp_tpu — accelerator-native globally-optimal point-cloud registration.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the CUDA
Go-ICP reference (ICP + Go-ICP branch-and-bound registration, five run
modes, TOML scenario configs, PLY/TXT point-cloud IO, live solver-state
reporting, result artifacts), re-designed around batched device work:

- bound evaluation is *batched over cubes* (``[B]`` leading axis) instead of
  one CUDA kernel launch per translation node on a stream
  (reference: ``src/fgoicp/registration.cu:88-151``),
- nearest-neighbor distance comes from a dense distance field queried with
  vectorized gathers (reference: 3D CUDA texture, ``registration.cu:179-296``)
  or from exact brute force recast as tiled dense ops and fused Pallas
  kernels
  (reference: ``src/fgoicp/icp3d.cu:13-30``),
- the local ICP refiner is a jitted ``lax.while_loop`` batched over poses
  (reference refines one pose at a time, ``src/fgoicp/fgoicp.cpp:75-91``),
- multi-chip scaling is a ``jax.sharding.Mesh`` + ``shard_map`` over point
  and cube axes (the reference is single-GPU).

Component map (reference inventory in SURVEY.md §2 → modules here):

=====  =======================================  ==============================
ref    what                                     goicp_tpu module
=====  =======================================  ==============================
C1     entry point / app driver                 ``goicp_tpu.cli``
C2     config system                            ``goicp_tpu.core.config``
C3     point-cloud loader                       ``goicp_tpu.io``
C4     logger                                   ``goicp_tpu.core.logging``
C5     stream pool                              batching axis (``bnb.bounds``)
C6     BnB node types                           ``goicp_tpu.core.types``
C7     GL buffers / VBO bridge                  ``goicp_tpu.viz`` (artifacts)
C8     per-frame ICP steps                      ``goicp_tpu.icp``
C9     flattened k-d tree (GPU)                 ``goicp_tpu.nn.kdtree`` (oracle)
C10    CPU Go-ICP (jly)                         ``goicp_tpu.bnb.solver`` (+ oracle in tests)
C11    3D distance transform                    ``goicp_tpu.nn.grid``
C12    CPU ICP w/ kd-tree                       ``goicp_tpu.icp``
C13    intro_select trimming                    ``lax.top_k`` paths + native introselect
C14    matrix lib                               jnp + ``goicp_tpu.geo``
C15    FastGoICP orchestrator                   ``goicp_tpu.bnb.solver``
C16    GPU ICP (icp3d)                          ``goicp_tpu.icp``
C17    registration / bound evaluator           ``goicp_tpu.bnb.bounds``
C18    NearestNeighborLUT                       ``goicp_tpu.nn.grid``
C19    viz-state bridge                         ``goicp_tpu.core.progress``
C20    window / camera / shaders                ``goicp_tpu.viz`` (PLY/PNG, live
                                                snapshots, HTML replay viewer)
C21    build system                             setup via ``goicp_tpu/_native/Makefile``
C22    data & scenarios                         ``scenarios/`` + ``tools/make_targets.py``
C23    vendored third-party                     none (stdlib + jax + numpy)
=====  =======================================  ==============================
"""

__version__ = "0.1.0"

from goicp_tpu.core.config import Config, Mode
from goicp_tpu.core.types import RigidTransform


def register(src, tgt, params=None, **kwargs):
    """Top-level convenience: globally-optimal registration.

    ``register(src, tgt, mse_threshold=1e-3)`` — kwargs build a
    :class:`goicp_tpu.bnb.BnbParams` when ``params`` is not given.
    """
    from goicp_tpu.bnb import BnbParams
    from goicp_tpu.bnb import register as _register

    if params is None:
        params = BnbParams(**kwargs)
    return _register(src, tgt, params)


__all__ = ["Config", "Mode", "RigidTransform", "register", "__version__"]
