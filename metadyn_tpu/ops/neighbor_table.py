"""Slot neighbor table: per-slot neighbor indices for the order CVs.

Reference parity: HOOMD's ``NeighborList`` consumed by ``SteinhardtQl``
(recalled, SURVEY.md §2b NeighborList row, §2a Steinhardt row) — the
GPU plugin evaluates Y_lm over an explicit per-particle neighbor list,
not over all candidate pairs.

Why: the 27-offset roll sweep evaluates the order-CV math on EVERY
(cap, cap, cell) pair slot and masks — at Config-3 density only ~4-12%
of those slots are real pairs inside the CV cutoffs (counted from the
shapes).  The table compacts the sweep ONCE per repack into a fixed
(K, Npad) index table so the per-step sweeps touch only real pairs, at
the price of indexed gathers.  Whether that pays on the GPU is not
measured yet; select it with ``PackedEngine(nbr_table=...)``.

Freshness contract: built with radius ``r_nb >= max CV r_cut +
spec.skin``, the table stays complete between distance-triggered
repacks (pair distances drift at most ``skin`` before the half-skin
trigger fires), and slot indices stay valid because slots only move AT
a repack.  Completeness also requires ``r_nb <= min cell width`` (the
27-cell stencil guarantee) — asserted by the engine.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .packed import PackedSpec, PackedState, _roll_offsets


def build_slot_neighbor_table(
    state: PackedState, spec: PackedSpec, r_nb: float, K: int,
) -> tuple[jax.Array, jax.Array]:
    """FULL neighbor table over the packed slot layout.

    Returns ``(tbl, overflow)``: ``tbl`` is ``(K, Npad)`` i32 of global
    flat slot indices (each unordered pair listed from BOTH sides), with
    ``Npad`` as the vacant sentinel; ``overflow`` is True iff any slot
    has more than K neighbors within ``r_nb`` (table incomplete — the
    engine surfaces it like a cell-capacity overflow).

    Enumeration order (offset-major, then source slot rank) is
    deterministic — reductions over the table are bit-reproducible.
    """
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    npad = spec.n_pad
    r2cut = jnp.float32(r_nb * r_nb)
    view = lambda a: a.reshape(cap, cx, cy, cz)
    x4 = [view(state.r[d].reshape(cap, C)) for d in range(3)]
    valid = (state.pid < spec.n_real).reshape(cap, C)
    valid4 = view(valid)
    vi = valid[None, :, :]                       # (1, capi, C)
    xi = [state.r[d].reshape(cap, C)[None, :, :] for d in range(3)]
    L = state.box.L

    lin3 = np.arange(C, dtype=np.int32).reshape(cx, cy, cz)
    islot = (np.arange(cap, dtype=np.int32)[:, None] * C
             + np.arange(C, dtype=np.int32)[None, :])      # (capi, C)
    islot_j = jnp.asarray(islot)

    tbl = jnp.full(K * npad + 1, npad, jnp.int32)
    base = jnp.zeros((cap, C), jnp.int32)        # neighbors found per i-slot
    for (o, ushift) in _roll_offsets(spec):
        roll = lambda a: jnp.roll(a, shift=(-o[0], -o[1], -o[2]),
                                  axis=(1, 2, 3))
        shift = jnp.asarray(ushift)
        r2 = jnp.zeros((cap, cap, C), jnp.float32)
        for d in range(3):
            xj = roll(x4[d]).reshape(cap, C) + shift[d][None, :] * L[d]
            c = xi[d] - xj[:, None, :]
            r2 = r2 + c * c
        vj = roll(valid4).reshape(cap, C)[:, None, :]
        m = vi & vj & (r2 < r2cut)
        if o == (0, 0, 0):
            # exclude self by slot identity (not by distance: two real
            # particles may coincide transiently)
            jj = np.arange(cap, dtype=np.int32)
            m = m & jnp.asarray(jj[:, None] != jj[None, :])[:, :, None]
        # global slot index of each candidate (static per offset)
        nc = np.roll(lin3, shift=(-o[0], -o[1], -o[2]),
                     axis=(0, 1, 2)).reshape(C)
        jslot = (np.arange(cap, dtype=np.int32)[:, None] * C
                 + nc[None, :])                              # (capj, C)
        jslot = jnp.asarray(jslot)[:, None, :]               # (capj, 1, C)
        # rank of this arrival at its i-slot: prior-offset count + rank
        # within this offset's source column
        rank = base[None, :, :] + (jnp.cumsum(m, axis=0, dtype=jnp.int32)
                                   - m)
        ok = m & (rank < K)
        dest = jnp.where(ok, rank * npad + islot_j[None, :, :], K * npad)
        tbl = tbl.at[dest.reshape(-1)].set(
            jnp.broadcast_to(jslot, (cap, cap, C)).reshape(-1), mode="drop")
        base = base + jnp.sum(m, axis=0, dtype=jnp.int32)
    overflow = jnp.any(base > K)
    return tbl[:-1].reshape(K, npad), overflow
