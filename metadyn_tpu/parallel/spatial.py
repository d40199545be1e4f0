"""Spatial domain decomposition: packed cell grid sharded over chips.

Reference parity: HOOMD's MPI spatial decomposition — ``Communicator``
sub-boxes with ghost-particle layers exchanged every step and particle
migration between ranks (recalled, SURVEY.md §2b Communicator row, §3.1
``Communicator::communicate``, §5 "scaling-N analog", §7 P8).  This is
the second scaling axis next to data-parallel walkers: it shards the
PARTICLES (via their cells) so N can grow past one chip's HBM/FLOPs.

Design.  The packed slot layout (cap, cx, cy, cz) is
sharded along the x cell axis over a ``"space"`` mesh axis; each device
owns cx/ndev contiguous x-planes.  Two shard_map islands implement the
halo-structured ops, everything else (integrators, CV reductions, bias
grids) stays global jnp — GSPMD shards the elementwise math and inserts
the collectives for the CV partial sums (the reference's
``MPI_Allreduce`` of CV partial sums, SURVEY.md §3.2):

1. **Force** (:func:`make_sharded_lj_force`): the 27-offset roll force
   needs exactly ONE neighbor x-plane per side, fetched with
   ``jax.lax.ppermute`` over the ring.  Positions crossing the periodic
   seam are shifted by ±Lx in transit so the pair math stays
   absolute-coordinate.  Bonds are supported: ghost planes carry pids and
   FENE partner attrs, so in-kernel bond matching sees cross-boundary
   partners.  Energy/virial are psum-reduced with ghost i-cells masked
   out (each unordered pair counted exactly twice globally, as in the
   single-device kernel).

2. **Migration** (:func:`make_sharded_repack`): the sharded twin of
   ``ops.packed.repack_incremental`` — HOOMD's particle migration,
   without any global repack.  Each device halo-extends ALL slot columns
   (positions, velocities, forces, images, pid, type, attrs) by one
   ghost plane per side, then runs the 27-offset sort-free slot
   assignment on the extended grid, keeping only arrivals into its
   interior planes.  A particle leaving a shard lands in the neighbor's
   ghost plane and is claimed by the neighbor's interior — ownership
   transfers with zero host traffic.  Coordinates crossing the periodic
   seam are shifted by ±Lx with a paired image-counter adjustment, so
   unwrapped trajectories (MSD CV) stay exact.  The arrival ranking
   matches the single-device repack order exactly (offset-major, then
   source column, then slot rank), so the sharded slot assignment is
   bit-identical to the single-device one.

:class:`SpatialPackedEngine` packages both behind the standard engine
protocol, so ``MetadSampler`` runs biased MD under the ``"space"`` axis
unchanged — integrate + ghost exchange + migration + CV psum + hill
deposit, end-to-end (the reference's full DD step loop, SURVEY.md §3.1).

Why 1-D slabs and not the reference's 3-D sub-boxes: a slab
decomposition needs one ``ppermute`` per side per exchange and no
corner/edge messages (26 neighbor messages per step in a 3-D MPI
decomposition collapse to 2), and each exchanged plane is one contiguous
(cap, 1, cy, cz) block.  The cost is halo volume: with ``cx`` x-planes
over ``ndev`` devices the ghost fraction is ``2·ndev/cx`` (≈25% at 1M
particles on 8 devices, 34³ cells), where 3-D sub-boxes would scale it
as the surface/volume ratio.  A 2-D split of the cell grid
(parallel/spatial2d.py) is the extension when device counts approach
``cx``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.box import Box
from ..core.packed_engine import PackedEngine, PackedAux
from ..ops.packed import (
    PackedSpec, PackedState, needs_repack, _scatter_rows, VACANT_X, _frac3,
    _cart3,
)
from ..ops.packed_triton import pair_force


def _shard_map(fn, mesh, in_specs, out_specs, axis_names=None,
               check_vma=True):
    """shard_map with optional partial-manual axes.

    ``mesh=None`` + ``axis_names={...}`` builds a NESTED island: the mesh
    resolves from the enclosing shard_map's context at call time and only
    ``axis_names`` become manual here — how the spatial islands run inside
    an outer ``"walkers"`` shard_map (walkers x space product meshes).

    ``check_vma=False`` is for islands that run the Pallas interpreter
    (CPU tests): it slices varying operands with unvarying indices, which
    the varying-axes checker refuses.  Their outputs come back unvarying;
    :func:`_vary_like` marks them again.
    """
    kw = {}
    if mesh is not None:
        kw["mesh"] = mesh
    if axis_names is not None:
        kw["axis_names"] = frozenset(axis_names)
    if not check_vma:
        kw["check_vma"] = False
    return jax.shard_map(fn, in_specs=in_specs, out_specs=out_specs, **kw)


def _vary_like(outs, ref):
    """``outs`` plus a zero carrying ``ref``'s varying mesh axes — for the
    outputs of a ``check_vma=False`` island nested in a checked one."""
    tag = 0.0 * ref[(0,) * ref.ndim]
    return [o + tag for o in outs]


def _halo_exchange(plane_lo, plane_hi, axis: str, n_dev: int):
    """Ring ppermute: send my low/high boundary x-planes to my left/right
    neighbors; returns (left_halo, right_halo) received from them.
    Works on stacked (W, cap, plane) tensors — one collective per side."""
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]   # to the right
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]   # to the left
    # my left halo = left neighbor's HIGH plane (arrives via fwd ring)
    left_halo = jax.lax.ppermute(plane_hi, axis, fwd)
    # my right halo = right neighbor's LOW plane (arrives via bwd ring)
    right_halo = jax.lax.ppermute(plane_lo, axis, bwd)
    return left_halo, right_halo


def _force_attr_names(spec: PackedSpec) -> list[str]:
    names = ["se", "hs"]
    if spec.has_bonds:
        names += [f"bp{k}" for k in range(spec.bond_slots)]
    return names


def make_sharded_lj_force(spec: PackedSpec, mesh: Mesh, axis: str = "space",
                          nested: bool = False, pair_path: str = "xla",
                          with_energy: bool = True, interpret: bool = False):
    """Build ``force(state) -> state`` with the cell grid sharded along x.

    ``state`` holds GLOBAL (cap, C)-flat slot arrays; under ``jit`` +
    ``shard_map`` each device touches only its x-slab plus two ghost
    planes.  Bonds supported (ghost planes carry pid + FENE partner
    attrs).  Requires ``cx % n_dev == 0``.  ``nested=True`` builds the
    island for use INSIDE an enclosing shard_map (e.g. over a
    ``"walkers"`` axis of the same mesh): only ``axis`` goes manual and
    the mesh resolves from the calling context.

    ``pair_path`` picks the pair force run on the halo-extended local
    grid (``ops.packed_triton.pair_force``).  Interior i-cells have all 26
    neighbour cells inside the extended grid, so their forces are exact;
    the ghost planes' forces are discarded, and the cell mask keeps ghost
    i-cells out of the energy/virial sums.  ``with_energy=False`` lets
    the kernel skip those sums (inner MD steps).
    """
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    n_dev = mesh.shape[axis]
    assert cx % n_dev == 0, (
        f"x cell count {cx} must divide over {n_dev} devices")
    cx_l = cx // n_dev
    assert cx_l >= 1
    plane = cy * cz                      # cells per x-plane
    C_l = cx_l * plane

    spec_ext = spec.replace(cells_per_dim=(cx_l + 2, cy, cz))
    # interior mask over extended cells: ghost planes excluded from the
    # energy/virial sums (each pair then counted exactly twice globally)
    interior = np.ones((cx_l + 2, plane), np.float32)
    interior[0] = 0.0
    interior[-1] = 0.0
    interior = jnp.asarray(interior.reshape(-1))
    attr_names = _force_attr_names(spec)

    def local_force(r, pid, typ, attrs, box_L, shard_ix, *tilt_arg):
        """Per-device body: r (3, cap, C_l), pid/typ (cap, C_l) i32,
        attrs dict of (cap, C_l).  A trailing ``tilt`` operand selects
        the triclinic path (trace-static): the slab axis is FRACTIONAL
        x, whose lattice vector a1 = h·(1,0,0) = (Lx, 0, 0) under the
        HOOMD upper-triangular h — so the seam shift is the same ±Lx
        x-shift as the orthorhombic case, and the in-kernel roll shifts
        are h-matrix lattice vectors (shift_rows_cart)."""
        box = Box(L=box_L, tilt=tilt_arg[0] if tilt_arg else None)
        # shard index arrives as a P(axis)-sharded iota rather than
        # jax.lax.axis_index: axis_index's partition-id lowering breaks
        # inside a NESTED shard_map (it re-binds the parent's manual axis)
        idx = shard_ix[0]
        Lx = box_L[0]

        # one stacked halo exchange of every column the pair math reads
        # (typ too: a ghost with typ=0 would read row 0 of the ε/σ tables)
        npad_ext = cap * (cx_l + 2) * plane
        cols = ([r[d] for d in range(3)]
                + [pid.astype(jnp.float32), typ.astype(jnp.float32)]
                + [attrs[k] for k in attr_names])
        v4 = [c.reshape(cap, cx_l, plane) for c in cols]
        lo = jnp.stack([c[:, 0] for c in v4])        # (W, cap, plane)
        hi = jnp.stack([c[:, -1] for c in v4])
        lh, rh = _halo_exchange(lo, hi, axis, n_dev)
        # periodic seam: x coordinates shift by ∓Lx crossing it
        lh = lh.at[0].add(jnp.where(idx == 0, -Lx, 0.0))
        rh = rh.at[0].add(jnp.where(idx == n_dev - 1, Lx, 0.0))
        ext = [jnp.concatenate([lh[i][:, None], v4[i], rh[i][:, None]],
                               axis=1).reshape(cap, -1)
               for i in range(len(cols))]

        r_ext = jnp.stack(ext[0:3])
        st_ext = PackedState(
            r=r_ext.reshape(3, -1), v=jnp.zeros((3, npad_ext)),
            f=jnp.zeros((3, npad_ext)),
            image=jnp.zeros((3, npad_ext), jnp.int32),
            ref_r=r_ext.reshape(3, -1),
            pid=ext[3].astype(jnp.int32).reshape(-1),
            typ=ext[4].astype(jnp.int32).reshape(-1),
            slot_of=jnp.zeros(1, jnp.int32),
            attrs={k: v.reshape(-1) for k, v in zip(attr_names, ext[5:])},
            box=box,
            potential_energy=jnp.float32(0.0),
            virial=jnp.zeros(3, jnp.float32))
        out = pair_force(st_ext, spec_ext, pair_path,
                         with_energy=with_energy, cell_mask=interior,
                         interpret=interpret)
        # keep interior planes only; reduce the scalars over the ring
        f_loc = out.f.reshape(3, cap, cx_l + 2, plane)[:, :, 1:-1]
        e = jax.lax.psum(out.potential_energy, axis)
        w = jax.lax.psum(out.virial, axis)
        return f_loc.reshape(3, cap, C_l), e, w

    # the flat slot axis is cap-major/C-minor, so sharding must apply to
    # the (cap, C) VIEW along C (contiguous chunks of C are x-slabs)
    islands = {}

    def get_island(tilted: bool):
        if tilted not in islands:
            islands[tilted] = _shard_map(
                local_force, None if nested else mesh,
                in_specs=(P(None, None, axis), P(None, axis),
                          P(None, axis),
                          {k: P(None, axis) for k in attr_names},
                          P(), P(axis)) + ((P(),) if tilted else ()),
                out_specs=(P(None, None, axis), P(), P()),
                axis_names=(axis,) if nested else None,
                check_vma=not interpret,
            )
        return islands[tilted]

    shard_iota = jnp.arange(n_dev, dtype=jnp.int32)

    def force(state: PackedState) -> PackedState:
        tilted = state.box.tilt is not None
        extra = (state.box.tilt,) if tilted else ()
        f, e, w = get_island(tilted)(
            state.r.reshape(3, cap, C),
            state.pid.reshape(cap, C),
            state.typ.reshape(cap, C),
            {k: state.attrs[k].reshape(cap, C)
             for k in attr_names},
            state.box.L, shard_iota, *extra)
        if interpret:
            f, e, w = _vary_like((f, e, w), state.r)
        state = state.replace(f=f.reshape(3, cap * C))
        if not (with_energy or pair_path == "xla"):
            return state      # the kernel skipped the scalar sums
        return state.replace(potential_energy=e, virial=w)

    return force


def make_sharded_repack(spec: PackedSpec, mesh: Mesh, axis: str = "space",
                        nested: bool = False):
    """Sharded incremental repack: slot migration with ghost-plane
    ownership handoff; no global repack (see module docstring).

    Returns ``repack(state) -> (state, bad)`` on GLOBAL (cap, C)-flat
    slot arrays.  ``bad`` is True iff the global particle count changed
    (a particle moved >1 cell between rebuilds, or a cell overflowed its
    capacity) — the sharded analog of ``repack_incremental``'s flag.
    ``nested``: see :func:`make_sharded_lj_force`.
    """
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    n_dev = mesh.shape[axis]
    assert cx % n_dev == 0
    cx_l = cx // n_dev
    plane = cy * cz
    C_l = cx_l * plane
    cx_e = cx_l + 2                       # extended planes incl. ghosts
    C_e = cx_e * plane
    n_pad_l = cap * C_l

    # static per-cell coords of the EXTENDED local grid
    ex, ey, ez = np.unravel_index(np.arange(C_e), (cx_e, cy, cz))
    ex = ex.astype(np.int32)

    def local_repack(r, v, f, im, pid, typ, attrs, box_L, shard_ix,
                     *tilt_arg):
        """Per-device body; all arrays (cap, C_l) (r/v/f/im: (3, cap, C_l)).

        Triclinic (trailing ``tilt`` operand, trace-static): binning and
        wraps go FRACTIONAL (f = h⁻¹r); the x seam shift stays ±Lx
        because a1 = (Lx, 0, 0) under the HOOMD upper-triangular h, and
        image counters count lattice vectors as everywhere else."""
        box = Box(L=box_L, tilt=tilt_arg[0] if tilt_arg else None)
        idx = shard_ix[0]      # P(axis)-sharded iota; see local_force
        L = box_L
        attr_keys = sorted(attrs.keys())

        # wrap y/z now (slab-local, safe — fractional x is INVARIANT
        # under a2/a3 wraps, so slab membership is unaffected); x is
        # wrapped AFTER migration so the shifted seam frame stays
        # consistent.  Orthorhombic compiles to the plain divide.
        im = im.astype(jnp.float32)
        f3w = _frac3(r.reshape(3, -1), box)
        shy = jnp.floor(f3w[1] + 0.5)
        shz = jnp.floor(f3w[2] + 0.5)
        shv = jnp.stack([jnp.zeros_like(shy), shy, shz])
        r = r - _cart3(shv, box).reshape(r.shape)
        im = im.at[1].add(shy.reshape(im.shape[1:]))
        im = im.at[2].add(shz.reshape(im.shape[1:]))

        # --- halo-extend every column (one stacked exchange per side) ---
        # pid travels as pid+1 with 0 = vacant (the repack convention:
        # zero-filled dropped rows read as vacant after the scatter)
        pid1_col = jnp.where(pid < spec.n_real, pid + 1, 0) \
            .astype(jnp.float32)
        cols = ([r[d] for d in range(3)] + [v[d] for d in range(3)]
                + [f[d] for d in range(3)] + [im[d] for d in range(3)]
                + [pid1_col, typ.astype(jnp.float32)]
                + [attrs[k] for k in attr_keys])
        v4 = [c.reshape(cap, cx_l, plane) for c in cols]
        lo = jnp.stack([c[:, 0] for c in v4])
        hi = jnp.stack([c[:, -1] for c in v4])
        lh, rh = _halo_exchange(lo, hi, axis, n_dev)
        # seam shift with PAIRED image adjustment: x' = x ∓ Lx,
        # image_x' = image_x ± 1 keeps the unwrapped coordinate invariant
        at_lo = (idx == 0)
        at_hi = (idx == n_dev - 1)
        lh = lh.at[0].add(jnp.where(at_lo, -L[0], 0.0))
        lh = lh.at[9].add(jnp.where(at_lo, 1.0, 0.0))
        rh = rh.at[0].add(jnp.where(at_hi, L[0], 0.0))
        rh = rh.at[9].add(jnp.where(at_hi, -1.0, 0.0))
        ext = [jnp.concatenate([lh[i][:, None], v4[i], rh[i][:, None]],
                               axis=1).reshape(cap, C_e)
               for i in range(len(cols))]
        valid2 = ext[12] > 0                             # (cap, C_e)

        # --- new cell coords in the extended local frame ----------------
        # FRACTIONAL binning (h⁻¹; the plain divide when orthorhombic).
        # x: UNCLIPPED global plane from the (possibly seam-shifted)
        # coordinate, then to extended-local (interior planes = 1..cx_l);
        # a ±a1 seam shift moves fx by exactly ∓1
        f3e = _frac3(jnp.stack(ext[0:3]).reshape(3, -1), box) \
            .reshape(3, cap, C_e)
        gx = jnp.floor((f3e[0] + 0.5) * cx).astype(jnp.int32)
        lx = gx - idx * cx_l + 1
        new_y = jnp.clip(jnp.floor((f3e[1] + 0.5) * cy)
                         .astype(jnp.int32), 0, cy - 1)
        new_z = jnp.clip(jnp.floor((f3e[2] + 0.5) * cz)
                         .astype(jnp.int32), 0, cz - 1)

        # --- 27-offset sort-free assignment over the extended grid ------
        # identical enumeration and ranking order to repack_incremental:
        # rank = arrivals-from-earlier-offsets at my destination + rank
        # within my (offset, source-column) group — so slot assignment is
        # bit-identical to the single-device repack.
        slot_new = jnp.full((cap, C_e), n_pad_l, jnp.int32)
        base = jnp.zeros((cx_l, cy, cz), jnp.int32)   # arrivals per INTERIOR cell
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    tgt_x = ex + ox                        # (C_e,) static
                    in_int = (tgt_x >= 1) & (tgt_x <= cx_l)
                    tgt_y = (ey + oy) % cy
                    tgt_z = (ez + oz) % cz
                    m = (valid2 & jnp.asarray(in_int)[None, :]
                         & (lx == jnp.asarray(tgt_x)[None, :])
                         & (new_y == jnp.asarray(tgt_y)[None, :])
                         & (new_z == jnp.asarray(tgt_z)[None, :]))
                    grp_rank = jnp.cumsum(m, axis=0, dtype=jnp.int32) - m
                    # base at my destination, brought to the source frame:
                    # pad base with 2 zero planes per side, static x-slice
                    base_pad = jnp.pad(base, ((2, 2), (0, 0), (0, 0)))
                    base_src = jnp.roll(base_pad, shift=(-oy, -oz),
                                        axis=(1, 2))[1 + ox:1 + ox + cx_e]
                    r_new = base_src.reshape(C_e)[None, :] + grp_rank
                    dest_lin = (((tgt_x - 1) * cy + tgt_y) * cz + tgt_z)
                    dest_lin = np.where(in_int, dest_lin, 0).astype(np.int32)
                    s = r_new * C_l + jnp.asarray(dest_lin)[None, :]
                    ok = m & (r_new < cap)
                    slot_new = jnp.where(ok, s, slot_new)
                    # arrivals via this offset, interior-destination-indexed
                    col_cnt = jnp.sum(m, axis=0, dtype=jnp.int32) \
                        .reshape(cx_e, cy, cz)
                    base = base + jnp.roll(col_cnt, shift=(oy, oz),
                                           axis=(1, 2))[1 - ox:1 - ox + cx_l]
                    # one materialization per offset (ops/packed.py
                    # repack_incremental: compile time on the GPU)
                    slot_new, base = jax.lax.optimization_barrier(
                        (slot_new, base))

        # --- scatter all columns into the local interior ----------------
        slot = slot_new.reshape(-1)
        out = _scatter_rows([c.reshape(-1) for c in ext], slot, n_pad_l)
        r_n = jnp.stack(out[0:3])
        im_n = jnp.stack(out[9:12])
        pid1 = out[12]
        valid_new = pid1 > 0
        # wrap x of migrated seam particles (y/z already wrapped; paired
        # image update keeps unwrapped coordinates exact).  Fractional
        # shx; the Cartesian correction is a1·shx = (Lx·shx, 0, 0) under
        # tilt too (upper-triangular h)
        shx = jnp.floor(_frac3(r_n, box)[0] + 0.5)
        r_n = r_n.at[0].add(-L[0] * shx)
        im_n = (im_n.at[0].add(shx)).astype(jnp.int32)
        if spec.uniform_eps is not None:
            r_n = jnp.where(valid_new[None, :], r_n, jnp.float32(VACANT_X))
        sentinel = jax.lax.pmax(jnp.max(ext[13]), axis)
        # halo stacking carried pid/typ as f32 (exact below 2^24); back to i32
        pid_n = jnp.where(valid_new, pid1 - 1.0,
                          jnp.float32(spec.n_real)).astype(jnp.int32)
        typ_n = jnp.where(valid_new, out[13], sentinel).astype(jnp.int32)
        attrs_n = dict(zip(attr_keys, out[14:]))

        # integrity: exactly n_real particles must exist globally — a lost
        # particle (moved >1 cell) or a capacity overflow changes the count
        count = jax.lax.psum(jnp.sum(valid_new, dtype=jnp.int32), axis)
        bad = count != jnp.int32(spec.n_real)

        # global slot_of by pid: local slots → global flat slots, psummed
        j = jnp.arange(n_pad_l, dtype=jnp.int32)
        gslot = (j // C_l) * C + idx * C_l + (j % C_l)
        slot_of = jnp.zeros(spec.n_real, jnp.int32).at[pid_n].set(
            jnp.where(valid_new, gslot, 0), mode="drop")
        slot_of = jax.lax.psum(slot_of, axis)

        shp = lambda a: a.reshape(cap, C_l)
        return (jnp.stack([shp(r_n[d]) for d in range(3)]),
                jnp.stack([shp(out[3 + d]) for d in range(3)]),
                jnp.stack([shp(out[6 + d]) for d in range(3)]),
                jnp.stack([shp(im_n[d]) for d in range(3)]),
                shp(pid_n), shp(typ_n),
                {k: shp(a) for k, a in attrs_n.items()},
                bad, slot_of)

    def specs_for(attrs_keys, tilted):
        adict = {k: P(None, axis) for k in attrs_keys}
        return (
            (P(None, None, axis),) * 4      # r, v, f, image
            + (P(None, axis),) * 2          # pid, typ
            + (adict, P(), P(axis))         # attrs, box_L, shard iota
            + ((P(),) if tilted else ()),   # tilt factors
            (P(None, None, axis),) * 4 + (P(None, axis),) * 2
            + ({k: P(None, axis) for k in attrs_keys}, P(), P()),
        )

    shard_iota = jnp.arange(n_dev, dtype=jnp.int32)

    def repack(state: PackedState):
        keys = sorted(state.attrs.keys())
        tilted = state.box.tilt is not None
        in_specs, out_specs = specs_for(keys, tilted)
        fn = _shard_map(local_repack, None if nested else mesh,
                        in_specs, out_specs,
                        axis_names=(axis,) if nested else None)
        extra = (state.box.tilt,) if tilted else ()
        view2 = lambda a: a.reshape(cap, C)
        view3 = lambda a: a.reshape(3, cap, C)
        r, v, f, im, pid, typ, attrs, bad, slot_of = fn(
            view3(state.r), view3(state.v), view3(state.f),
            view3(state.image), view2(state.pid), view2(state.typ),
            {k: view2(state.attrs[k]) for k in keys}, state.box.L,
            shard_iota, *extra)
        flat3 = lambda a: a.reshape(3, cap * C)
        r = flat3(r)
        return state.replace(
            r=r, v=flat3(v), f=flat3(f), image=flat3(im),
            ref_r=r, pid=pid.reshape(-1), typ=typ.reshape(-1),
            slot_of=slot_of,
            attrs={k: a.reshape(-1) for k, a in attrs.items()},
        ), bad

    return repack


class SpatialPackedEngine(PackedEngine):
    """PackedEngine with the cell grid sharded over a ``"space"`` mesh
    axis: ghost-plane force exchange + sharded migration, behind the
    standard engine protocol — ``MetadSampler`` and the packed CVs run
    on top unchanged (their reductions become XLA collectives).

    The state keeps its GLOBAL (3, Npad) layout; the halo-structured ops
    are shard_map islands, the elementwise integrator math and CV
    reductions are GSPMD-sharded by XLA.
    """

    def __init__(self, spec: PackedSpec, mesh: Mesh, axis: str = "space",
                 rebuild_every: int = 1, mass: float = 1.0,
                 nested: bool = False, walker_axis: str = "walkers",
                 pair_path: Optional[str] = None,
                 always_repack: bool = False,
                 with_energy: bool = False,
                 interpret: bool = False):
        """``nested=True`` builds the halo islands for use inside an
        enclosing shard_map over ``walker_axis`` of ``mesh`` (the
        reference's ``mpirun -n W*S --nrank W`` — walker partitions each
        internally domain-decomposed): pass the full product mesh here and
        the same mesh to
        :class:`~metadyn_tpu.parallel.walkers.WalkerSampler`.

        ``pair_path``, ``with_energy`` and ``interpret`` as in
        :class:`PackedEngine`; the pair force runs on the halo-extended
        local grid (:func:`make_sharded_lj_force`)."""
        super().__init__(spec, rebuild_every=rebuild_every,
                         pair_path=pair_path, mass=mass,
                         with_energy=with_energy,
                         always_repack=always_repack, interpret=interpret)
        self.mesh = mesh
        self.axis = axis
        self._nested_islands = nested
        self._walker_axis = walker_axis
        build = lambda e: make_sharded_lj_force(
            spec, mesh, axis, nested=nested, pair_path=self.pair_path,
            with_energy=e, interpret=interpret)
        sharded_force = build(with_energy)
        sharded_force_e = build(True)
        self._sharded_repack = make_sharded_repack(spec, mesh, axis,
                                                   nested=nested)
        self._force = lambda st, sp: sharded_force(st)
        self._force_e = lambda st, sp: sharded_force_e(st)

    def rebuild(self, state: PackedState, aux: PackedAux):
        # the repack decision is a GLOBAL scalar (max displacement over
        # all shards), so every device takes the same cond branch and the
        # collectives inside the sharded repack line up
        need = (jnp.asarray(True) if self.always_repack
                else needs_repack(state, self.spec))
        if self._nested_islands:
            # product meshes: the decision must ALSO be uniform across
            # walkers — the repack's space-ring collectives rendezvous
            # over every device of the op, so a walker whose trigger
            # fires while another's doesn't would deadlock the fused
            # collective.  Repacking a walker a few steps early is exact
            # (the repack is a no-op reassignment then); a diverged
            # branch is a hang.
            need = jax.lax.pmax(need.astype(jnp.int32),
                                self._walker_axis) > 0
        state, bad = jax.lax.cond(
            need, self._sharded_repack, lambda st: (st, st.pid[0] < -1),
            state)
        return state, PackedAux(overflow=aux.overflow | bad, stale=aux.stale)
