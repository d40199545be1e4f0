"""Bonded forces: harmonic and FENE bead-spring bonds.

Reference parity: HOOMD-blue ``PotentialBondHarmonic`` / ``PotentialBondFENE``
(SURVEY.md §2b) — needed for the bead-spring diblock copolymer melt configs
(BASELINE.json:8,11).

Design: gather–compute–scatter-add over the static bond table; the
scatter-add is deterministic (an improvement over CUDA atomics — SURVEY.md §5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.box import Box, minimum_image
from .pairs import PairForceResult


@struct.dataclass
class HarmonicBondParams:
    k: jax.Array   # (n_bond_types,) spring constant
    r0: jax.Array  # (n_bond_types,) rest length


@struct.dataclass
class FENEBondParams:
    k: jax.Array        # (n_bond_types,)
    r0: jax.Array       # (n_bond_types,) maximum extension
    epsilon: jax.Array  # (n_bond_types,) WCA epsilon of the bonded pair
    sigma: jax.Array    # (n_bond_types,)


def harmonic_bond_force(
    pos: jax.Array, bonds: jax.Array, bond_types: jax.Array,
    box: Box, params: HarmonicBondParams,
) -> PairForceResult:
    """u = ½ k (r − r0)²  over the bond table (B, 2)."""
    if bonds.shape[0] == 0:
        z = jnp.float32(0.0)
        return PairForceResult(z, jnp.zeros_like(pos), jnp.zeros(3))
    i, j = bonds[:, 0], bonds[:, 1]
    dr = minimum_image(pos[i] - pos[j], box)
    r2 = jnp.sum(dr * dr, axis=-1)
    r = jnp.sqrt(r2)
    k = params.k[bond_types]
    r0 = params.r0[bond_types]
    e = 0.5 * k * (r - r0) ** 2
    coef = -k * (r - r0) / r                     # F_i = coef * dr
    f_pair = coef[:, None] * dr
    force = jnp.zeros_like(pos).at[i].add(f_pair).at[j].add(-f_pair)
    return PairForceResult(jnp.sum(e), force, jnp.sum(f_pair * dr, axis=0))


def fene_bond_force(
    pos: jax.Array, bonds: jax.Array, bond_types: jax.Array,
    box: Box, params: FENEBondParams,
) -> PairForceResult:
    """FENE + WCA bead-spring bond (Kremer–Grest):
    u = −½ k r0² ln(1 − (r/r0)²) + WCA(r)."""
    if bonds.shape[0] == 0:
        z = jnp.float32(0.0)
        return PairForceResult(z, jnp.zeros_like(pos), jnp.zeros(3))
    i, j = bonds[:, 0], bonds[:, 1]
    dr = minimum_image(pos[i] - pos[j], box)
    r2 = jnp.sum(dr * dr, axis=-1)
    k = params.k[bond_types]
    r0 = params.r0[bond_types]
    eps = params.epsilon[bond_types]
    sig = params.sigma[bond_types]
    # FENE part — clamp (r/r0)² below 1 for safety at blowup
    x = jnp.minimum(r2 / (r0 * r0), 0.99)
    e_fene = -0.5 * k * r0 * r0 * jnp.log1p(-x)
    coef_fene = -k / (1.0 - x)                  # F = coef * dr
    # WCA part, cut at 2^(1/6) σ
    rc2 = (2.0 ** (1.0 / 3.0)) * sig * sig
    inside = r2 < rc2
    r2s = jnp.where(inside, r2, 1.0)
    s2 = sig * sig / r2s
    s6 = s2 * s2 * s2
    e_wca = jnp.where(inside, 4.0 * eps * (s6 * s6 - s6) + eps, 0.0)
    coef_wca = jnp.where(inside, 4.0 * eps * (12.0 * s6 * s6 - 6.0 * s6) / r2s, 0.0)
    e = e_fene + e_wca
    coef = coef_fene + coef_wca
    f_pair = coef[:, None] * dr
    force = jnp.zeros_like(pos).at[i].add(f_pair).at[j].add(-f_pair)
    return PairForceResult(jnp.sum(e), force, jnp.sum(f_pair * dr, axis=0))
