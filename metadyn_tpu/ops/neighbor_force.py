"""Pair forces over a fixed neighbor list — the per-step hot op.

Reference parity: HOOMD's ``PotentialPair*GPU`` neighbor-traversal CUDA
kernels (SURVEY.md §2c item 8).  Full-list formulation: every pair appears
on both rows, so the force is a pure gather + VPU reduction with no
scatter — energy and virial take the ½ factor.

Layout: all wide intermediates are (N, K) with K minor; coordinates are
handled as separate components so no (N, K, 3) array is materialized.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.box import Box
from .cell_list import NeighborList
from .pairs import PairKernel, PairParams, PairForceResult


def neighbor_pair_force(
    pos: jax.Array,
    types: jax.Array,
    box: Box,
    nbr: NeighborList,
    kernel: PairKernel,
    params: PairParams,
) -> PairForceResult:
    n = pos.shape[0]
    j = nbr.idx                                   # (N, K), sentinel n
    mask = j < n
    j_safe = jnp.minimum(j, n)
    dx = []
    r2 = jnp.zeros(j.shape, pos.dtype)
    for d in range(3):
        comp_pad = jnp.concatenate([pos[:, d], jnp.zeros((1,), pos.dtype)])
        c = pos[:, d][:, None] - comp_pad[j_safe]
        L = box.L[d]
        c = c - L * jnp.round(c / L)
        dx.append(c)
        r2 = r2 + c * c
    # sentinel rows → huge r2 so the kernel's cutoff masks them
    r2 = jnp.where(mask, r2, 1e30)
    types_pad = jnp.concatenate([types, jnp.zeros((1,), types.dtype)])
    tj = types_pad[j_safe]
    e, coef = kernel(r2, types[:, None], tj, params)
    force = jnp.stack([jnp.sum(coef * c, axis=1) for c in dx], axis=1)
    w = jnp.stack([jnp.sum(jnp.where(mask, coef * c * c, 0.0)) for c in dx])
    return PairForceResult(0.5 * jnp.sum(e), force, 0.5 * w)
