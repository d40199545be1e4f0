"""Cell list + fixed-capacity neighbor list (particle-order engines).

Reference parity: HOOMD-blue ``CellList`` / ``NeighborList`` (CUDA
bin-and-traverse kernels; SURVEY.md §2b/§2c item 7).  This is the
BASELINE.json:5 "Pallas cell-list and neighbor kernels replace HOOMD's
ParticleData and integration core" requirement.

Design (SURVEY.md §7 tenet 3 — fixed shapes everywhere):

1. **Binning by sort** (deterministic, unlike CUDA atomics): particles are
   argsorted by linear cell id; the rank of each particle within its cell
   indexes into a dense (n_cells, capacity) table.  The sort and the
   scatter are deterministic — bit-reproducible cell lists, an
   improvement over the reference documented in SURVEY.md §5.
2. **27-cell candidate gather** → (N, 27·capacity) candidates, distance
   filter, then **compaction by stable sort** to a fixed (N, max_neighbors)
   FULL neighbor list (each pair listed from both sides: double compute, no
   scatter in the hot force loop).
3. **Overflow flags** (cell capacity, neighbor capacity) surfaced to
   metrics instead of dynamic reallocation; capacities are chosen with
   headroom at build time and re-validated every rebuild.

The force evaluation over the fixed list lives in ops/neighbor_force.py and
has a Pallas twin for the hot path.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.box import Box, minimum_image


@struct.dataclass
class CellSpec:
    """Static geometry of the cell decomposition (compile-time constants)."""

    cells_per_dim: tuple = struct.field(pytree_node=False)   # (cx, cy, cz)
    cell_capacity: int = struct.field(pytree_node=False)
    max_neighbors: int = struct.field(pytree_node=False)
    r_cut: float = struct.field(pytree_node=False)
    skin: float = struct.field(pytree_node=False)

    @property
    def n_cells(self) -> int:
        cx, cy, cz = self.cells_per_dim
        return cx * cy * cz

    @property
    def r_list(self) -> float:
        return self.r_cut + self.skin

    @classmethod
    def create(
        cls,
        box_L,
        n_particles: int,
        r_cut: float,
        skin: float = 0.4,
        cell_capacity: int | None = None,
        max_neighbors: int | None = None,
    ) -> "CellSpec":
        """Choose static dims from concrete box lengths + density headroom."""
        L = np.asarray(box_L, np.float64).reshape(-1)
        if L.size == 1:
            L = np.repeat(L, 3)
        r_list = r_cut + skin
        # Clamping to 3 cells per dim is SAFE: with exactly 3 cells the
        # {-1,0,+1} stencil spans every cell of that dimension, so no true
        # neighbor can be outside the 27-cell candidate set even when the
        # cell width drops below r_list (the minimum-image distance filter
        # culls the rest).  It merely degrades toward all-pairs cost.
        # Differentially tested vs all-pairs at L < 3·r_list in
        # tests/test_neighbor.py::test_neighbor_force_matches_all_pairs.
        cpd = tuple(max(3, int(np.floor(l / r_list))) for l in L)
        n_cells = int(np.prod(cpd))
        density = n_particles / float(np.prod(L))
        cell_vol = float(np.prod(L)) / n_cells
        if cell_capacity is None:
            # mean occupancy with 3x headroom, at least 4
            cell_capacity = max(4, int(np.ceil(density * cell_vol * 3.0)))
        if max_neighbors is None:
            # particles within r_list sphere with 2x headroom
            mean_nbrs = density * 4.0 / 3.0 * np.pi * r_list**3
            max_neighbors = max(8, int(np.ceil(mean_nbrs * 2.0)))
        # round the neighbor capacity up to a multiple of 8
        max_neighbors = ((max_neighbors + 7) // 8) * 8
        return cls(cells_per_dim=cpd, cell_capacity=cell_capacity,
                   max_neighbors=max_neighbors, r_cut=r_cut, skin=skin)


@struct.dataclass
class NeighborList:
    """Fixed-shape full neighbor list + rebuild bookkeeping."""

    idx: jax.Array        # (N, max_neighbors) i32; sentinel = N for padding
    ref_pos: jax.Array    # (N, 3) positions at build time (displacement check)
    overflow: jax.Array   # () bool — any capacity overflow at build
    spec: CellSpec


_OFFSETS = np.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    np.int32,
)  # (27, 3)


def _cell_coords(pos: jax.Array, box: Box, spec: CellSpec) -> jax.Array:
    assert box.tilt is None, (
        "the particle-order cell list is orthorhombic-only — triclinic "
        "runs use the all-pairs engine or the packed cell engine "
        "(fractional binning, ops/packed.py)")
    cpd = jnp.asarray(spec.cells_per_dim, jnp.int32)
    # positions live in [-L/2, L/2); map to [0, 1) then cells
    frac = pos / box.L + 0.5
    c = jnp.floor(frac * cpd.astype(pos.dtype)).astype(jnp.int32)
    return jnp.clip(c, 0, cpd - 1)


def _linear_id(c: jax.Array, spec: CellSpec) -> jax.Array:
    cx, cy, cz = spec.cells_per_dim
    return (c[..., 0] * cy + c[..., 1]) * cz + c[..., 2]


def build_neighbor_list(
    pos: jax.Array,
    box: Box,
    spec: CellSpec,
    exclusions: jax.Array | None = None,
) -> NeighborList:
    """Build the (N, max_neighbors) full list.  ``exclusions`` is an
    (N, E) i32 table of particle ids to drop (HOOMD's bonded-pair
    exclusions), sentinel N.

    Every wide intermediate is kept 2-D with the wide axis minor, and
    compaction uses cumsum + flat scatter instead of a (N, 27·cap) row
    sort.
    """
    n = pos.shape[0]
    cid = _linear_id(_cell_coords(pos, box, spec), spec)            # (N,)
    order = jnp.argsort(cid)
    sorted_cid = cid[order]
    # rank of each sorted particle within its cell
    rank = jnp.arange(n, dtype=jnp.int32) - jnp.searchsorted(
        sorted_cid, sorted_cid, side="left").astype(jnp.int32)
    cell_overflow = jnp.any(rank >= spec.cell_capacity)
    table_size = spec.n_cells * spec.cell_capacity
    # overflow rows go to the explicit drop slot (index table_size): a
    # rank >= cap must NOT land in the next cell's slot range where it
    # would evict a legitimate particle
    tbl_idx = jnp.where(rank < spec.cell_capacity,
                        sorted_cid * spec.cell_capacity + rank, table_size)
    table = jnp.full((table_size + 1,), n, jnp.int32)
    table = table.at[tbl_idx].set(order.astype(jnp.int32), mode="drop")
    table = table[:table_size]                                       # (C·cap,)

    # 27 neighbor cells per particle (periodic wrap)
    cpd = jnp.asarray(spec.cells_per_dim, jnp.int32)
    my_cell = _cell_coords(pos, box, spec)                           # (N, 3)
    nbr_cells = jnp.mod(my_cell[:, None, :] + _OFFSETS[None, :, :], cpd)  # (N,27,3)
    nbr_cid = _linear_id(nbr_cells, spec)                            # (N, 27)
    cap = spec.cell_capacity
    # flat gather indices, kept (N, 27·cap) throughout
    slot = jnp.tile(jnp.arange(cap, dtype=jnp.int32), 27)            # (27·cap,)
    flat_idx = jnp.repeat(nbr_cid, cap, axis=1) * cap + slot[None, :]
    cand = table[flat_idx]                                           # (N, 27·cap)

    # distance filter — SoA per-component math, all (N, 27·cap)
    cand_safe = jnp.minimum(cand, n)
    r2 = jnp.zeros(cand.shape, pos.dtype)
    for d in range(3):
        comp_pad = jnp.concatenate([pos[:, d], jnp.zeros((1,), pos.dtype)])
        dx = pos[:, d][:, None] - comp_pad[cand_safe]
        L = box.L[d]
        dx = dx - L * jnp.round(dx / L)
        r2 = r2 + dx * dx
    i_ids = jnp.arange(n, dtype=jnp.int32)[:, None]
    ok = (r2 < spec.r_list**2) & (cand != n) & (cand != i_ids)
    if exclusions is not None:
        excl = jnp.zeros(cand.shape, bool)
        for e in range(exclusions.shape[1]):
            excl = excl | (cand == exclusions[:, e][:, None])
        ok = ok & ~excl
    n_valid = jnp.sum(ok, axis=1)
    nbr_overflow = jnp.any(n_valid > spec.max_neighbors)

    # compact: column slot via exclusive cumsum of the valid mask, then one
    # flat scatter into the (N, max_neighbors) list (deterministic)
    k = spec.max_neighbors
    col = jnp.cumsum(ok.astype(jnp.int32), axis=1) - 1               # (N, 27·cap)
    dest = jnp.where(ok & (col < k), i_ids * k + col, n * k)         # drop slot
    idx = jnp.full((n * k + 1,), n, jnp.int32)
    idx = idx.at[dest].set(cand, mode="drop")
    idx = idx[: n * k].reshape(n, k)
    return NeighborList(
        idx=idx, ref_pos=pos, overflow=cell_overflow | nbr_overflow, spec=spec)


def needs_rebuild(nbr: NeighborList, pos: jax.Array, box: Box) -> jax.Array:
    """Half-skin displacement criterion (HOOMD's distance-check trigger)."""
    d = minimum_image(pos - nbr.ref_pos, box)
    return jnp.max(jnp.sum(d * d, axis=-1)) > (0.5 * nbr.spec.skin) ** 2


def exclusions_from_bonds(bonds: np.ndarray, n: int, max_excl: int = 8) -> jnp.ndarray:
    """Host-side: (N, max_excl) exclusion table from a bond list (HOOMD's
    default 1-2 exclusions)."""
    table = np.full((n, max_excl), n, np.int32)
    count = np.zeros(n, np.int32)
    for a, b in np.asarray(bonds):
        for x, y in ((a, b), (b, a)):
            if count[x] < max_excl:
                table[x, count[x]] = y
                count[x] += 1
            else:
                raise ValueError(f"particle {x} exceeds max_excl={max_excl}")
    return jnp.asarray(table)
