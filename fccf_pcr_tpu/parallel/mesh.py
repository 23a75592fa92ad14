"""Multi-chip scaling: data-parallel registration over a device mesh.

The reference is a sequential single-core program (SURVEY.md §2,
"Parallelism & distributed communication": none exists to port). The
scaling axes for this workload are:

  - *intra-pair*: every stage is already a batched tensor program on one
    device (features/, hypotheses/, verify/);
  - *across pairs*: `vmap` + sharding of the pair axis over a
    `jax.sharding.Mesh` ('data',). XLA partitions the whole pipeline
    SPMD; per-pair work is independent so no collectives are required in
    steady state — exactly the "batch parallelism over scan pairs" design
    from SURVEY.md §2. Collectives (a psum, over NVLink on one GPU host)
    appear only in the optional metric reductions below.

This module provides the mesh plumbing plus a sharded sweep driver for
whole-dataset registration (BASELINE.md coverage configs, e.g. the
full-ETH consecutive-pair sweep over the GPUs of one host). The mesh is
one flat axis: every card reaches every other at the same rate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Capacities, FCCFParams
from ..pipeline.register import register_pair


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_sharded_register_fn(
    params: FCCFParams,
    caps: Capacities,
    mesh: Mesh,
    axis_name: str = "data",
):
    """Batched registration with the pair axis sharded over the mesh.

    Input arrays must have a leading pair axis divisible by the mesh size.
    Outputs inherit the same sharding (fully independent per-pair results);
    XLA inserts no cross-chip communication in the hot path.
    """
    batched = jax.vmap(
        functools.partial(register_pair, params=params, caps=caps)
    )
    data_sharding = NamedSharding(mesh, P(axis_name))
    return jax.jit(
        batched,
        in_shardings=(data_sharding,) * 4,
        out_shardings=data_sharding,
    )


def sharded_mean_errors(T_est, T_gt, mesh, axis_name: str = "data"):
    """Mean RRE/RTE over a sharded batch — an example of an explicit
    cross-device reduction (psum) for sweep summaries."""
    from ..pipeline.metrics import registration_errors

    def local(te, tg):
        rre, rte = registration_errors(te, tg)
        n = jnp.float32(te.shape[0])
        s = jnp.stack([jnp.sum(rre), jnp.sum(rte), n])
        return jax.lax.psum(s, axis_name)

    spec = NamedSharding(mesh, P(axis_name))
    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=(P(axis_name), P(axis_name)),
            out_specs=P(),
        ),
        in_shardings=(spec, spec),
    )
    s = fn(T_est, T_gt)
    return s[0] / s[2], s[1] / s[2]
