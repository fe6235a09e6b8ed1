"""Sharding context: lets the SMC core annotate particle tensors without
depending on the parallel layer.

The reference is single-device (SURVEY.md §2-B); the rebuild's parallelism is
two mesh axes — "data" (trajectory batch) and "particle" (the K axis, the
workload's EP-analog). Rather than thread mesh objects through every function,
`psvo_tpu.smc` calls `constrain(x)` on its [B, K, ...] tensors; when a mesh is
active (set by `psvo_tpu.parallel.sharding`), this lowers to
`jax.lax.with_sharding_constraint`, and GSPMD propagates the layout through
the whole scan, inserting collectives (psum for the weight normalizer,
all-gathers for cross-shard resampling) where needed. When no mesh is active
it is a no-op, so the single-chip path pays nothing.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_MESH: Optional[Mesh] = None

DATA_AXIS = "data"
PARTICLE_AXIS = "particle"


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def constrain(x: jax.Array, *, has_particles: bool = True) -> jax.Array:
    """Constrain a batch-leading tensor.

    Particle tensors are channel-major: the K axis is LAST ([B, K] weights,
    [B, D, K] particles — see distributions.mvn_diag_log_prob_cm), so the
    particle mesh axis binds to the final dim.
    """
    if _MESH is None:
        return x
    if has_particles and x.ndim >= 2:
        spec = P(DATA_AXIS, *([None] * (x.ndim - 2)), PARTICLE_AXIS)
    else:
        spec = P(DATA_AXIS, *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(x, NamedSharding(_MESH, spec))
