"""2-D spatial domain decomposition: cell grid sharded over x AND y.

Reference parity: HOOMD's ``Communicator`` decomposes the box into 3-D
sub-boxes (recalled, SURVEY.md §2b Communicator row); the 1-D slab
decomposition (parallel/spatial.py) caps at ``cx`` devices with ghost
fraction ``2·ndev/cx``.  This module is the named natural extension
(round-3 VERDICT missing #6): an ``("spacex", "spacey")`` product mesh
shards the x and y cell axes, so N_dev scales to ``cx·cy`` and the ghost
fraction falls toward the surface/volume ratio.

Same invariants as the 1-D module:

* **Two-hop halo exchange.**  x-halos first (one ``ppermute`` per side
  over ``spacex``), then y-halos of the x-EXTENDED arrays (over
  ``spacey``) — the second hop carries the corner ghosts, so no separate
  corner messages exist (the 26-message 3-D MPI pattern collapses to 4
  nearest-neighbor permutes).
* **Force** = the unmodified pair force (either pair path) on the
  (cx_l+2, cy_l+2, cz) extended local grid with ghost cells masked out
  of the scalars.  Interior cells are buffered on both sharded axes, so
  every periodic-wrapped pair of the (non-periodic) extended grid has a
  ghost i-cell and is discarded — the same proof as the 1-D slab.
* **Migration** = the sort-free 27-offset arrival ranking on the
  extended grid, keeping interior arrivals only; ownership hands off
  through the ghost layer with seam shifts (±L, paired image updates)
  applied independently per sharded axis (corners compound both).  The
  enumeration order matches ``ops.packed.repack_incremental``, so slot
  assignment is bit-identical to the single-device repack.

z stays unsharded.  Orthorhombic only.
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
    PackedSpec, PackedState, needs_repack, _scatter_rows, VACANT_X,
)
from ..ops.packed_triton import pair_force
from .spatial import _force_attr_names, _shard_map, _vary_like


def _ring(n_dev: int):
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    return fwd, bwd


def _exchange_axis(v, axis_dim: int, axis_name: str, n_dev: int):
    """Halo-extend ``v`` (stacked (W, cap, ...grid...)) along grid dim
    ``axis_dim`` by one plane per side via ring ppermutes.  Returns the
    extended array and the (at_lo, at_hi) plane index slices for seam
    fixups (applied by the caller)."""
    fwd, bwd = _ring(n_dev)
    lo = jax.lax.index_in_dim(v, 0, axis_dim, keepdims=True)
    hi = jax.lax.index_in_dim(v, v.shape[axis_dim] - 1, axis_dim,
                              keepdims=True)
    lh = jax.lax.ppermute(hi, axis_name, fwd)   # left neighbor's high
    rh = jax.lax.ppermute(lo, axis_name, bwd)   # right neighbor's low
    return lh, rh


def _seam_add(ext, comp: int, plane_slice, amount):
    """Add ``amount`` to component ``comp`` of the stacked array on the
    given ghost-plane slice (seam shift / image fixup)."""
    upd = ext[(comp,) + plane_slice] + amount
    return ext.at[(comp,) + plane_slice].set(upd)


def make_sharded_lj_force_2d(spec: PackedSpec, mesh: Mesh,
                             axes=("spacex", "spacey"),
                             nested: bool = False, pair_path: str = "xla",
                             with_energy: bool = True,
                             interpret: bool = False):
    """``force(state) -> state`` with the cell grid sharded over x and y.

    Same contract as :func:`parallel.spatial.make_sharded_lj_force`
    (global (cap, C)-flat state; energy/virial psum-reduced with ghost
    i-cells masked).  Requires ``cx % n_x == 0`` and ``cy % n_y == 0``.

    ``nested=True`` builds the island for use INSIDE an enclosing
    shard_map (walkers x 2-D space): only ``axes`` go manual and the mesh
    resolves from the calling context.  ``pair_path``, ``with_energy``
    and ``interpret`` as in the 1-D builder.
    """
    ax, ay = axes
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    n_x, n_y = mesh.shape[ax], mesh.shape[ay]
    assert cx % n_x == 0 and cy % n_y == 0, (
        f"cells ({cx},{cy}) must divide over the ({n_x},{n_y}) mesh")
    cx_l, cy_l = cx // n_x, cy // n_y
    cx_e, cy_e = cx_l + 2, cy_l + 2
    C_l = cx_l * cy_l * cz

    spec_ext = spec.replace(cells_per_dim=(cx_e, cy_e, cz))
    interior = np.zeros((cx_e, cy_e, cz), np.float32)
    interior[1:-1, 1:-1, :] = 1.0
    interior = jnp.asarray(interior.reshape(-1))
    attr_names = _force_attr_names(spec)

    def extend(cols4, box_L, ix, iy, x_comp=None, y_comp=None,
               imx_comp=None, imy_comp=None):
        """Two-hop halo extension of stacked (W, cap, cx_l, cy_l, cz)
        columns → (W, cap, cx_e, cy_e, cz), with per-axis seam shifts on
        coordinate components and paired image fixups (migration)."""
        v = cols4
        # --- x hop ---
        lh, rh = _exchange_axis(v, 2, ax, n_x)
        if x_comp is not None:
            at_lo = (ix == 0)
            at_hi = (ix == n_x - 1)
            lh = _seam_add(lh, x_comp, np.s_[:, :, :, :],
                           jnp.where(at_lo, -box_L[0], 0.0))
            rh = _seam_add(rh, x_comp, np.s_[:, :, :, :],
                           jnp.where(at_hi, box_L[0], 0.0))
            if imx_comp is not None:
                lh = _seam_add(lh, imx_comp, np.s_[:, :, :, :],
                               jnp.where(at_lo, 1.0, 0.0))
                rh = _seam_add(rh, imx_comp, np.s_[:, :, :, :],
                               jnp.where(at_hi, -1.0, 0.0))
        v = jnp.concatenate([lh, v, rh], axis=2)
        # --- y hop (carries the x-ghost corners too) ---
        lh, rh = _exchange_axis(v, 3, ay, n_y)
        if y_comp is not None:
            at_lo = (iy == 0)
            at_hi = (iy == n_y - 1)
            lh = _seam_add(lh, y_comp, np.s_[:, :, :, :],
                           jnp.where(at_lo, -box_L[1], 0.0))
            rh = _seam_add(rh, y_comp, np.s_[:, :, :, :],
                           jnp.where(at_hi, box_L[1], 0.0))
            if imy_comp is not None:
                lh = _seam_add(lh, imy_comp, np.s_[:, :, :, :],
                               jnp.where(at_lo, 1.0, 0.0))
                rh = _seam_add(rh, imy_comp, np.s_[:, :, :, :],
                               jnp.where(at_hi, -1.0, 0.0))
        return jnp.concatenate([lh, v, rh], axis=3)

    def local_force(r, pid, typ, attrs, box_L, six, siy):
        ix = six[0]
        iy = siy[0]
        # typ rides the halo exchange when a per-type-pair table indexes
        # it in the kernel (a typ=0 ghost would read table row 0)
        cols = [r[d] for d in range(3)] + [pid.astype(jnp.float32)] \
            + [typ.astype(jnp.float32)] \
            + [attrs[k] for k in attr_names]
        v = jnp.stack([c.reshape(cap, cx_l, cy_l, cz) for c in cols])
        ext = extend(v, box_L, ix, iy, x_comp=0, y_comp=1)
        npad_ext = cap * cx_e * cy_e * cz
        flat = [ext[i].reshape(cap, -1).reshape(-1)
                for i in range(len(cols))]
        r_ext = jnp.stack(flat[0:3])
        st_ext = PackedState(
            r=r_ext, v=jnp.zeros((3, npad_ext)),
            f=jnp.zeros((3, npad_ext)),
            image=jnp.zeros((3, npad_ext), jnp.int32),
            ref_r=r_ext,
            pid=flat[3].astype(jnp.int32),
            typ=flat[4].astype(jnp.int32),
            slot_of=jnp.zeros(1, jnp.int32),
            attrs=dict(zip(attr_names, flat[5:])),
            box=Box(L=box_L),
            potential_energy=jnp.float32(0.0),
            virial=jnp.zeros(3, jnp.float32))
        out = pair_force(st_ext, spec_ext, pair_path,
                         with_energy=with_energy, cell_mask=interior,
                         interpret=interpret)
        e = jax.lax.psum(out.potential_energy, (ax, ay))
        w = jax.lax.psum(out.virial, (ax, ay))
        f_loc = out.f.reshape(3, cap, cx_e, cy_e, cz)[:, :, 1:-1, 1:-1]
        return f_loc, e, w

    sharded = _shard_map(
        local_force, None if nested else mesh,
        in_specs=(P(None, None, ax, ay, None), P(None, ax, ay, None),
                  P(None, ax, ay, None),
                  {k: P(None, ax, ay, None) for k in attr_names},
                  P(), P(ax), P(ay)),
        out_specs=(P(None, None, ax, ay, None), P(), P()),
        axis_names=(ax, ay) if nested else None,
        check_vma=not interpret,
    )
    iota_x = jnp.arange(n_x, dtype=jnp.int32)
    iota_y = jnp.arange(n_y, dtype=jnp.int32)

    def force(state: PackedState) -> PackedState:
        assert state.box.tilt is None, "2-D DD: orthorhombic only"
        f, e, w = sharded(
            state.r.reshape(3, cap, cx, cy, cz),
            state.pid.reshape(cap, cx, cy, cz),
            state.typ.reshape(cap, cx, cy, cz),
            {k: state.attrs[k].reshape(cap, cx, cy, cz)
             for k in attr_names},
            state.box.L, iota_x, iota_y)
        if interpret:
            f, e, w = _vary_like((f, e, w), state.r)
        state = state.replace(f=f.reshape(3, cap * C))
        if not (with_energy or pair_path == "xla"):
            return state      # the kernel skipped the scalar sums
        return state.replace(potential_energy=e, virial=w)

    return force


def make_sharded_repack_2d(spec: PackedSpec, mesh: Mesh,
                           axes=("spacex", "spacey"),
                           nested: bool = False):
    """Sharded incremental repack over the 2-D mesh (see module
    docstring).  Returns ``repack(state) -> (state, bad)`` on GLOBAL
    (cap, C)-flat arrays; ``bad`` is True iff the global particle count
    changed.  ``nested``: see :func:`make_sharded_lj_force_2d`."""
    ax, ay = axes
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    n_x, n_y = mesh.shape[ax], mesh.shape[ay]
    assert cx % n_x == 0 and cy % n_y == 0
    cx_l, cy_l = cx // n_x, cy // n_y
    cx_e, cy_e = cx_l + 2, cy_l + 2
    C_l = cx_l * cy_l * cz
    C_e = cx_e * cy_e * cz
    n_pad_l = cap * C_l

    ex, ey, ez = np.unravel_index(np.arange(C_e), (cx_e, cy_e, cz))
    ex = ex.astype(np.int32)
    ey = ey.astype(np.int32)

    force_2d_extend = make_sharded_lj_force_2d  # noqa: F841 (doc link)

    def local_repack(r, v, f, im, pid, typ, attrs, box_L, six, siy):
        ix = six[0]
        iy = siy[0]
        L = box_L
        attr_keys = sorted(attrs.keys())

        # wrap z now (unsharded axis); x/y wrap AFTER migration so the
        # seam-shifted frames stay consistent
        im = im.astype(jnp.float32)
        sh = jnp.floor(r[2] / L[2] + 0.5)
        r = r.at[2].add(-L[2] * sh)
        im = im.at[2].add(sh)

        pid1_col = jnp.where(pid < spec.n_real, pid + 1, 0) \
            .astype(jnp.float32)
        cols = ([r[d] for d in range(3)] + [v[d] for d in range(3)]
                + [f[d] for d in range(3)] + [im[d] for d in range(3)]
                + [pid1_col, typ.astype(jnp.float32)]
                + [attrs[k] for k in attr_keys])
        v5 = jnp.stack([c.reshape(cap, cx_l, cy_l, cz) for c in cols])

        # two-hop extension with seam shifts + PAIRED image fixups:
        # components 0/1 = x/y coordinates, 9/10 = x/y image counters
        lh, rh = _exchange_axis(v5, 2, ax, n_x)
        at_lo, at_hi = (ix == 0), (ix == n_x - 1)
        lh = lh.at[0].add(jnp.where(at_lo, -L[0], 0.0))
        lh = lh.at[9].add(jnp.where(at_lo, 1.0, 0.0))
        rh = rh.at[0].add(jnp.where(at_hi, L[0], 0.0))
        rh = rh.at[9].add(jnp.where(at_hi, -1.0, 0.0))
        v5 = jnp.concatenate([lh, v5, rh], axis=2)
        lh, rh = _exchange_axis(v5, 3, ay, n_y)
        at_lo, at_hi = (iy == 0), (iy == n_y - 1)
        lh = lh.at[1].add(jnp.where(at_lo, -L[1], 0.0))
        lh = lh.at[10].add(jnp.where(at_lo, 1.0, 0.0))
        rh = rh.at[1].add(jnp.where(at_hi, L[1], 0.0))
        rh = rh.at[10].add(jnp.where(at_hi, -1.0, 0.0))
        v5 = jnp.concatenate([lh, v5, rh], axis=3)

        ext = [v5[i].reshape(cap, C_e) for i in range(len(cols))]
        valid2 = ext[12] > 0

        # new cell coords in the extended local frame (interior = 1..c_l)
        gx = jnp.floor((ext[0] / L[0] + 0.5) * cx).astype(jnp.int32)
        lx = gx - ix * cx_l + 1
        gy = jnp.floor((ext[1] / L[1] + 0.5) * cy).astype(jnp.int32)
        ly = gy - iy * cy_l + 1
        new_z = jnp.clip(jnp.floor((ext[2] / L[2] + 0.5) * cz)
                         .astype(jnp.int32), 0, cz - 1)

        # 27-offset sort-free assignment (enumeration order identical to
        # repack_incremental — bit-identical slot assignment)
        slot_new = jnp.full((cap, C_e), n_pad_l, jnp.int32)
        base = jnp.zeros((cx_l, cy_l, cz), jnp.int32)
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    tgt_x = ex + ox
                    tgt_y = ey + oy
                    tgt_z = (ez + oz) % cz
                    in_int = ((tgt_x >= 1) & (tgt_x <= cx_l)
                              & (tgt_y >= 1) & (tgt_y <= cy_l))
                    m = (valid2 & jnp.asarray(in_int)[None, :]
                         & (lx == jnp.asarray(tgt_x)[None, :])
                         & (ly == jnp.asarray(tgt_y)[None, :])
                         & (new_z == jnp.asarray(tgt_z)[None, :]))
                    grp_rank = jnp.cumsum(m, axis=0, dtype=jnp.int32) - m
                    base_pad = jnp.pad(base, ((2, 2), (2, 2), (0, 0)))
                    base_src = jnp.roll(base_pad, shift=-oz, axis=2)[
                        1 + ox:1 + ox + cx_e, 1 + oy:1 + oy + cy_e]
                    r_new = base_src.reshape(C_e)[None, :] + grp_rank
                    dest_lin = (((tgt_x - 1) * cy_l + (tgt_y - 1)) * cz
                                + tgt_z)
                    dest_lin = np.where(in_int, dest_lin, 0) \
                        .astype(np.int32)
                    s = r_new * C_l + jnp.asarray(dest_lin)[None, :]
                    ok = m & (r_new < cap)
                    slot_new = jnp.where(ok, s, slot_new)
                    col_cnt = jnp.sum(m, axis=0, dtype=jnp.int32) \
                        .reshape(cx_e, cy_e, cz)
                    base = base + jnp.roll(col_cnt, shift=oz, axis=2)[
                        1 - ox:1 - ox + cx_l, 1 - oy:1 - oy + cy_l]
                    # one materialization per offset (ops/packed.py
                    # repack_incremental: compile time on the GPU)
                    slot_new, base = jax.lax.optimization_barrier(
                        (slot_new, base))

        slot = slot_new.reshape(-1)
        out = _scatter_rows([c.reshape(-1) for c in ext], slot, n_pad_l)
        r_n = jnp.stack(out[0:3])
        im_n = jnp.stack(out[9:12])
        pid1 = out[12]
        valid_new = pid1 > 0
        for d in (0, 1):
            shd = jnp.floor(r_n[d] / L[d] + 0.5)
            r_n = r_n.at[d].add(-L[d] * shd)
            im_n = im_n.at[d].add(shd)
        im_n = im_n.astype(jnp.int32)
        if spec.uniform_eps is not None:
            r_n = jnp.where(valid_new[None, :], r_n, jnp.float32(VACANT_X))
        sentinel = jax.lax.pmax(jnp.max(ext[13]), (ax, ay))
        pid_n = jnp.where(valid_new, pid1 - 1.0,
                          jnp.float32(spec.n_real)).astype(jnp.int32)
        typ_n = jnp.where(valid_new, out[13], sentinel).astype(jnp.int32)
        attrs_n = dict(zip(attr_keys, out[14:]))

        count = jax.lax.psum(jnp.sum(valid_new, dtype=jnp.int32),
                             (ax, ay))
        bad = count != jnp.int32(spec.n_real)

        # global slot_of by pid: local cell (ixl, iyl, iz) → global cell
        j = jnp.arange(n_pad_l, dtype=jnp.int32)
        jc = j % C_l
        ixl = jc // (cy_l * cz)
        iyl = (jc // cz) % cy_l
        izl = jc % cz
        gcell = ((ix * cx_l + ixl) * cy + iy * cy_l + iyl) * cz + izl
        gslot = (j // C_l) * C + gcell
        slot_of = jnp.zeros(spec.n_real, jnp.int32).at[pid_n].set(
            jnp.where(valid_new, gslot, 0), mode="drop")
        slot_of = jax.lax.psum(slot_of, (ax, ay))

        shp = lambda a: a.reshape(cap, cx_l, cy_l, cz)
        return (jnp.stack([shp(r_n[d]) for d in range(3)]),
                jnp.stack([shp(out[3 + d]) for d in range(3)]),
                jnp.stack([shp(out[6 + d]) for d in range(3)]),
                jnp.stack([shp(im_n[d]) for d in range(3)]),
                shp(pid_n), shp(typ_n),
                {k: shp(a) for k, a in attrs_n.items()},
                bad, slot_of)

    def specs(attr_keys):
        adict = {k: P(None, ax, ay, None) for k in attr_keys}
        return (
            (P(None, None, ax, ay, None),) * 4
            + (P(None, ax, ay, None),) * 2
            + (adict, P(), P(ax), P(ay)),
            ((P(None, None, ax, ay, None),) * 4
             + (P(None, ax, ay, None),) * 2
             + ({k: P(None, ax, ay, None) for k in attr_keys}, P(), P())))

    iota_x = jnp.arange(n_x, dtype=jnp.int32)
    iota_y = jnp.arange(n_y, dtype=jnp.int32)

    def repack(state: PackedState):
        attr_keys = sorted(state.attrs.keys())
        in_specs, out_specs = specs(attr_keys)
        fn = _shard_map(local_repack, None if nested else mesh,
                        in_specs=in_specs, out_specs=out_specs,
                        axis_names=(ax, ay) if nested else None)
        view = lambda a: a.reshape(cap, cx, cy, cz)
        r_n, v_n, f_n, im_n, pid_n, typ_n, attrs_n, bad, slot_of = fn(
            state.r.reshape(3, cap, cx, cy, cz),
            state.v.reshape(3, cap, cx, cy, cz),
            state.f.reshape(3, cap, cx, cy, cz),
            state.image.reshape(3, cap, cx, cy, cz),
            view(state.pid), view(state.typ),
            {k: view(a) for k, a in state.attrs.items()},
            state.box.L, iota_x, iota_y)
        flat = lambda a: a.reshape(cap * C)
        return state.replace(
            r=r_n.reshape(3, -1), v=v_n.reshape(3, -1),
            f=f_n.reshape(3, -1), image=im_n.reshape(3, -1),
            ref_r=r_n.reshape(3, -1),
            pid=flat(pid_n), typ=flat(typ_n),
            slot_of=slot_of,
            attrs={k: flat(a) for k, a in attrs_n.items()}), bad

    return repack


class SpatialPackedEngine2D(PackedEngine):
    """PackedEngine with the cell grid sharded over an
    ``("spacex", "spacey")`` mesh — the 2-D analog of
    :class:`parallel.spatial.SpatialPackedEngine` (which remains the
    production 1-D slab engine; use 2-D when the device count exceeds
    ``cx`` or the slab ghost fraction ``2·n/cx`` dominates)."""

    def __init__(self, spec: PackedSpec, mesh: Mesh,
                 axes=("spacex", "spacey"), rebuild_every: int = 1,
                 mass: float = 1.0, always_repack: bool = False,
                 nested: bool = False, walker_axis: str = "walkers",
                 pair_path: Optional[str] = None,
                 with_energy: bool = False,
                 interpret: bool = False):
        """``nested=True`` builds the halo islands for use inside an
        enclosing shard_map over ``walker_axis`` (walkers x 2-D space —
        pass the full 3-axis product mesh here and the same mesh to
        ``WalkerSampler``).  ``pair_path``, ``with_energy`` and
        ``interpret`` as in :class:`PackedEngine`."""
        super().__init__(spec, rebuild_every=rebuild_every,
                         pair_path=pair_path, mass=mass,
                         with_energy=with_energy,
                         always_repack=always_repack, interpret=interpret)
        self.mesh = mesh
        self.axes = axes
        self._nested_islands = nested
        self._walker_axis = walker_axis
        build = lambda e: make_sharded_lj_force_2d(
            spec, mesh, axes, nested=nested, pair_path=self.pair_path,
            with_energy=e, interpret=interpret)
        sharded_force = build(with_energy)
        sharded_force_e = build(True)
        self._sharded_repack = make_sharded_repack_2d(spec, mesh, axes,
                                                      nested=nested)
        self._force = lambda st, sp: sharded_force(st)
        self._force_e = lambda st, sp: sharded_force_e(st)

    def rebuild(self, state: PackedState, aux: PackedAux):
        need = (jnp.asarray(True) if self.always_repack
                else needs_repack(state, self.spec))
        if self._nested_islands:
            # the repack's space-ring collectives rendezvous over every
            # device; a walker whose trigger diverges would deadlock the
            # fused collective (parallel/spatial.py rebuild parity)
            need = jax.lax.pmax(need.astype(jnp.int32),
                                self._walker_axis) > 0
        state, bad = jax.lax.cond(
            need, self._sharded_repack, lambda st: (st, st.pid[0] < -1),
            state)
        return state, PackedAux(overflow=aux.overflow | bad,
                                stale=aux.stale)
