"""Coplane-pair base enumeration and roughness typing.

Rebuild of ``select_base`` (FCCF.cpp:429-468, C9): all face pairs (i < j)
whose included angle lies strictly inside (30, 150) degrees become bases;
each base is typed 0/1/2 (smooth-smooth / rough-rough / mixed) from the
per-face roughness theta against ``rough_threshold`` = 2.

Tensor form: the pair list is a *static* lexicographic enumeration of the
F*(F-1)/2 upper-triangle pairs (matching the reference's nested-loop
order), with a validity mask instead of dynamic push_back.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FCCFParams
from ..features.faces import Faces
from ..ops import geometry


class Bases(NamedTuple):
    i: jax.Array       # (B,) int32 face index 1 (i < j)
    j: jax.Array       # (B,) int32 face index 2
    angle: jax.Array   # (B,) included angle, degrees
    type_: jax.Array   # (B,) int32 in {0,1,2}
    valid: jax.Array   # (B,) bool


def pair_indices(F: int):
    """Static (i, j) pairs, i<j, in the reference's nested-loop order."""
    ii, jj = np.triu_indices(F, k=1)
    return jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32)


def select_bases(faces: Faces, params: FCCFParams) -> Bases:
    F = faces.valid.shape[0]
    ii, jj = pair_indices(F)
    angle = geometry.angle_deg(faces.normal[ii], faces.normal[jj])
    valid = (
        faces.valid[ii]
        & faces.valid[jj]
        & (angle > params.angle_min)
        & (angle < params.angle_max)
    )
    rough_i = faces.theta[ii] > params.rough_threshold
    rough_j = faces.theta[jj] > params.rough_threshold
    # both smooth -> 0, both rough -> 1, mixed -> 2 (FCCF.cpp:454-461)
    type_ = jnp.where(
        rough_i == rough_j, jnp.where(rough_i, 1, 0), 2
    ).astype(jnp.int32)
    return Bases(i=ii, j=jj, angle=angle, type_=type_, valid=valid)
