"""Pair potentials and a row-blocked all-pairs force driver.

Reference parity: HOOMD-blue ``PotentialPairLJ`` & friends (SURVEY.md §2b) —
LJ (with energy shift), WCA, and a soft DPD-like repulsion for copolymer
melts.  Parameters are (n_types, n_types) tables like HOOMD's per-type-pair
coefficient matrices.

Design: a pair potential is a pure function of squared distance
``u(r2) -> (energy, minus_du_dr2)``; the all-pairs
driver streams row blocks with ``lax.map`` so memory stays O(block · N)
instead of O(N²).  The neighbor-list driver (ops/neighbor_list.py) reuses
the same pair functions on (N, max_neighbors) gathers.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.box import Box, minimum_image

# A pair kernel maps (r2, ti, tj, params) -> (energy_ij, coef_ij) where the
# pair force on i is  F_i = coef * (r_i - r_j)  with  coef = -2 du/d(r2).
PairKernel = Callable[[jax.Array, jax.Array, jax.Array, "PairParams"], tuple[jax.Array, jax.Array]]


@struct.dataclass
class PairParams:
    """Type-pair coefficient tables, (T, T) each; named like HOOMD's."""

    epsilon: jax.Array
    sigma: jax.Array
    r_cut: jax.Array
    shift_const: jax.Array  # energy shift at r_cut (precomputed; 0 disables)
    # xplor smoothing onset radius (HOOMD's mode="xplor"); None disables
    r_on: jax.Array = None


def lj_tables(
    n_types: int,
    epsilon=1.0,
    sigma=1.0,
    r_cut=2.5,
    shift: bool = True,
) -> PairParams:
    """Build LJ parameter tables.  Scalars broadcast to all type pairs;
    pass (T, T) arrays for per-pair coefficients."""
    T = n_types
    eps = jnp.broadcast_to(jnp.asarray(epsilon, jnp.float32), (T, T))
    sig = jnp.broadcast_to(jnp.asarray(sigma, jnp.float32), (T, T))
    rc = jnp.broadcast_to(jnp.asarray(r_cut, jnp.float32), (T, T))
    if shift:
        sr6 = (sig / rc) ** 6
        shift_c = 4.0 * eps * (sr6 * sr6 - sr6)
    else:
        shift_c = jnp.zeros((T, T), jnp.float32)
    return PairParams(epsilon=eps, sigma=sig, r_cut=rc, shift_const=shift_c)


def xplor_tables(
    n_types: int,
    epsilon=1.0,
    sigma=1.0,
    r_cut=2.5,
    r_on=2.0,
) -> PairParams:
    """LJ with XPLOR smoothing (HOOMD ``mode="xplor"``): the pair energy
    is multiplied by S(r) ramping smoothly 1 → 0 over [r_on, r_cut]
    (C¹ continuous — no force jump at the cutoff; no shift needed)."""
    T = n_types
    p = lj_tables(n_types, epsilon=epsilon, sigma=sigma, r_cut=r_cut,
                  shift=False)
    return p.replace(
        r_on=jnp.broadcast_to(jnp.asarray(r_on, jnp.float32), (T, T)))


def wca_tables(n_types: int, epsilon=1.0, sigma=1.0) -> PairParams:
    """WCA = LJ truncated & shifted at the minimum 2^(1/6) σ."""
    rc = (2.0 ** (1.0 / 6.0)) * jnp.broadcast_to(
        jnp.asarray(sigma, jnp.float32), (n_types, n_types)
    )
    return lj_tables(n_types, epsilon=epsilon, sigma=sigma, r_cut=rc, shift=True)


def lj_kernel(r2: jax.Array, ti: jax.Array, tj: jax.Array, p: PairParams):
    """Lennard-Jones 12-6.  u = 4ε[(σ/r)¹² − (σ/r)⁶] − u(r_cut)."""
    eps = p.epsilon[ti, tj]
    sig = p.sigma[ti, tj]
    rc2 = p.r_cut[ti, tj] ** 2
    # exclude r2≈0 (self pairs) so masked lanes can't poison autodiff with NaN
    inside = (r2 < rc2) & (r2 > 1e-12)
    r2s = jnp.where(inside, r2, 1.0)
    inv_r2 = sig * sig / r2s
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    e = 4.0 * eps * (inv_r6 * inv_r6 - inv_r6) - p.shift_const[ti, tj]
    # du/dr2 = -(4ε/r2)(12 (σ/r)^12 - 6 (σ/r)^6)/2 ⇒ coef = -2 du/dr2
    coef = 4.0 * eps * (12.0 * inv_r6 * inv_r6 - 6.0 * inv_r6) / r2s
    if p.r_on is not None:
        # XPLOR smoothing: u_s = S(r)·u with
        # S = (rc²−r²)²(rc²+2r²−3r_on²)/(rc²−r_on²)³ on [r_on, rc], 1 below;
        # dS/dr² = −6(rc²−r²)(r²−r_on²)/(rc²−r_on²)³
        ron2 = p.r_on[ti, tj] ** 2
        denom = (rc2 - ron2) ** 3
        in_ramp = (r2s > ron2)
        S = jnp.where(
            in_ramp,
            (rc2 - r2s) ** 2 * (rc2 + 2.0 * r2s - 3.0 * ron2) / denom,
            1.0)
        dSdr2 = jnp.where(
            in_ramp, -6.0 * (rc2 - r2s) * (r2s - ron2) / denom, 0.0)
        coef = S * coef - 2.0 * e * dSdr2
        e = S * e
    return jnp.where(inside, e, 0.0), jnp.where(inside, coef, 0.0)


def soft_tables(n_types: int, A=25.0, r_cut=1.0) -> PairParams:
    """Soft DPD-conservative repulsion tables (A stored in .epsilon)."""
    T = n_types
    return PairParams(
        epsilon=jnp.broadcast_to(jnp.asarray(A, jnp.float32), (T, T)),
        sigma=jnp.ones((T, T), jnp.float32),
        r_cut=jnp.broadcast_to(jnp.asarray(r_cut, jnp.float32), (T, T)),
        shift_const=jnp.zeros((T, T), jnp.float32),
    )


def soft_kernel(r2: jax.Array, ti: jax.Array, tj: jax.Array, p: PairParams):
    """DPD-conservative soft repulsion u = (A rc/2)(1 − r/rc)², F = A(1 − r/rc) r̂."""
    A = p.epsilon[ti, tj]
    rc = p.r_cut[ti, tj]
    inside = (r2 < rc * rc) & (r2 > 1e-12)
    r = jnp.sqrt(jnp.where(inside, r2, 1.0))
    x = 1.0 - r / rc
    e = 0.5 * A * rc * x * x
    coef = A * x / r  # F = coef * dr
    return jnp.where(inside, e, 0.0), jnp.where(inside, coef, 0.0)


class PairForceResult(NamedTuple):
    energy: jax.Array   # () total potential energy
    force: jax.Array    # (N, 3)
    virial: jax.Array   # (3,) diagonal virial  Σ_{i<j} f_ij,d · r_ij,d


def all_pairs_force(
    pos: jax.Array,
    types: jax.Array,
    box: Box,
    kernel: PairKernel,
    params: PairParams,
    row_block: int = 1024,
) -> PairForceResult:
    """O(N²) masked all-pairs force, streamed in row blocks.

    Correctness anchor for the neighbor-list path and the default driver for
    small systems (Config 1, SURVEY.md §6).  Memory is O(row_block · N).
    """
    n = pos.shape[0]
    row_block = min(row_block, n)
    n_blocks = -(-n // row_block)
    pad = n_blocks * row_block - n
    # pad rows; padded rows get type 0 and are masked out of the totals
    pos_p = jnp.concatenate([pos, jnp.zeros((pad, 3), pos.dtype)]) if pad else pos
    types_p = jnp.concatenate([types, jnp.zeros((pad,), types.dtype)]) if pad else types
    row_ids = jnp.arange(n_blocks * row_block, dtype=jnp.int32)
    col_ids = jnp.arange(n, dtype=jnp.int32)

    def block(b):
        sl = b * row_block
        rp = jax.lax.dynamic_slice_in_dim(pos_p, sl, row_block)
        rt = jax.lax.dynamic_slice_in_dim(types_p, sl, row_block)
        rid = jax.lax.dynamic_slice_in_dim(row_ids, sl, row_block)
        dr = minimum_image(rp[:, None, :] - pos[None, :, :], box)  # (B, N, 3)
        r2 = jnp.sum(dr * dr, axis=-1)
        e, coef = kernel(r2, rt[:, None], types[None, :], params)
        valid = (rid[:, None] != col_ids[None, :]) & (rid[:, None] < n)
        e = jnp.where(valid, e, 0.0)
        coef = jnp.where(valid, coef, 0.0)
        f = jnp.sum(coef[:, :, None] * dr, axis=1)          # (B, 3)
        w = jnp.sum(coef[:, :, None] * dr * dr, axis=(0, 1))  # (3,) per-axis
        return jnp.sum(e), f, w

    e_b, f_b, w_b = jax.lax.map(block, jnp.arange(n_blocks))
    force = f_b.reshape(-1, 3)[:n]
    # double counting: each unordered pair appears twice in the full sum
    return PairForceResult(0.5 * jnp.sum(e_b), force,
                           0.5 * jnp.sum(w_b, axis=0))
