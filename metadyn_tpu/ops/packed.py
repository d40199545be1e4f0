"""Packed cell-major MD state + the XLA roll-sweep pair force.

Reference parity: HOOMD's ``CellList`` + ``PotentialPair*GPU`` traversal
(SURVEY.md §2b/§2c).  The reference walks a per-particle neighbor index
list; this module keeps particles in cell-major slots instead, so a
pair sweep needs no neighbor list at all.

**Layout.**  Particles live permanently in *cell-major slot arrays*: flat
index ``slot = rank·C + cell`` reshaped as (cap, C) with the cell axis
minor (C = ncells).  Coordinates are SoA — separate (Npad,) x/y/z rows
of a (3, Npad) array.

**Pair force: the 27-offset roll method** (:func:`packed_lj_force`).  For
each of the 27 neighbor-cell offsets, the partner array is ``jnp.roll`` of
the (cap, cx, cy, cz) view — a static, contiguous permutation — plus a
precomputed ±L periodic shift per cell.  Pair interactions are then pure
broadcasts (cap_j, cap_i, C) reduced over cap_j, with zero dynamic
indexing.  ops/packed_triton.py computes the same forces in one GPU
kernel that reads neighbor columns by index.

**Vacancy masking for free.**  Pair parameters use per-slot
Lorentz–Berthelot factors (√ε_i, σ_i/2); vacant slots carry √ε = 0 so every
pair involving them contributes exactly zero — no extra mask ops.

**Rebuild.**  Every ``rebuild_every`` steps: recompute cell ids, rank by a
1-D sort (deterministic, unlike CUDA atomics), and re-scatter all slot
arrays (~10 element scatters at rebuild cadence, amortized ≪ step cost).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.box import Box, h_inverse, h_matrix

# Vacant-slot coordinate sentinel for the uniform-eps lean kernel: far
# outside any physical box (f32-exact), so vacant slots are culled by a
# STATIC position threshold (VACANT_THR) in the pair mask instead of a
# per-slot √ε=0 factor.  Real coordinates never exceed ~1.5·L ≪ THR.
VACANT_X = 1.0e7
VACANT_THR = 1.0e6


def _frac3(r: jax.Array, box: Box) -> jax.Array:
    """(3, M) Cartesian → (3, M) fractional rows (f = h⁻¹ r).

    The tilt branch is STATIC (selected at trace time): orthorhombic
    programs compile to the plain divide, exactly as before triclinic
    support (HOOMD BoxDim parity, SURVEY.md §2b)."""
    if box.tilt is None:
        return r / box.L[:, None]
    # explicit upper-triangular solve in elementwise f32 — NOT the
    # h_inverse matmul: a reduced-precision f32 matmul (TF32 on the GPU)
    # has ~1e-3 relative error, which corrupts binning/wrap positions
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    fz = r[2] / Lz
    fy = (r[1] - yz * r[2]) / Ly
    fx = (r[0] - xy * (r[1] - yz * r[2]) - xz * r[2]) / Lx
    return jnp.stack([fx, fy, fz])


def _cart3(f: jax.Array, box: Box) -> jax.Array:
    """(3, M) fractional → Cartesian rows (r = h f)."""
    if box.tilt is None:
        return f * box.L[:, None]
    # elementwise triangular product (see _frac3: exact f32, no matmul)
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    r2 = Lz * f[2]
    r1 = Ly * f[1] + yz * Lz * f[2]
    r0 = Lx * f[0] + xy * Ly * f[1] + xz * Lz * f[2]
    return jnp.stack([r0, r1, r2])


def shift_rows_cart(ushift, box: Box) -> jax.Array:
    """Lattice-unit periodic wrap counts (..., 3, C) → Cartesian shift
    rows of the same shape: orthorhombic u_d·L_d, triclinic h @ u per
    column.  Shared by every roll-sweep stack builder (packed_lj_force,
    the Triton pair kernel, the order-CV sweeps)."""
    u = jnp.asarray(ushift, jnp.float32)
    if box.tilt is None:
        L = jnp.reshape(jnp.asarray(box.L, jnp.float32),
                        (1,) * (u.ndim - 2) + (3, 1))
        return u * L
    # elementwise triangular product (exact f32, no matmul — see _frac3)
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    ux, uy, uz = u[..., 0, :], u[..., 1, :], u[..., 2, :]
    return jnp.stack([Lx * ux + xy * Ly * uy + xz * Lz * uz,
                      Ly * uy + yz * Lz * uz,
                      Lz * uz], axis=-2)


@struct.dataclass
class PackedSpec:
    """Static geometry: cell grid + slot capacity (compile-time)."""

    cells_per_dim: tuple = struct.field(pytree_node=False)  # (cx, cy, cz)
    cap: int = struct.field(pytree_node=False)
    n_real: int = struct.field(pytree_node=False)
    r_cut: float = struct.field(pytree_node=False)
    skin: float = struct.field(pytree_node=False)
    shift_energy: bool = struct.field(pytree_node=False, default=True)
    # Uniform pair sigma (σ_ij identical for every pair): lets the pair
    # kernel read no hs column at all.  All baseline configs are single-σ
    # (SURVEY.md §6).
    uniform_sigma: float = struct.field(pytree_node=False, default=None)
    # Uniform pair epsilon: with uniform_sigma the kernel reads no se
    # column either — vacancy is then
    # encoded by a STATIC far-away coordinate sentinel (VACANT_X) and a
    # static position threshold in the pair mask.
    uniform_eps: float = struct.field(pytree_node=False, default=None)
    # "lj" (default) or "soft" (DPD-conservative push-off; A = ε_i·ε_j
    # via the se attrs).  Soft runs on the XLA roll path only (push-off
    # phases are short; ops/packed_triton.choose_pair_path picks it).
    pair_kind: str = struct.field(pytree_node=False, default="lj")
    # Per-type-PAIR interaction tables (HOOMD ``PotentialPair`` parity:
    # independent coefficients per (type_i, type_j), SURVEY.md §2b —
    # e.g. ε_AB < √(ε_A·ε_B) for a demixing diblock).  Stored as STATIC
    # symmetric (n_types, n_types) SCALING tables relative to the
    # per-slot Lorentz–Berthelot base:  ε_ij = se_i·se_j·k_ε(ti, tj),
    # σ_ij = (hs_i + hs_j)·k_σ(ti, tj).  Any positive symmetric target
    # table is expressible (pick se_i = √ε_{aa}, k = ε_ab/√(ε_aa ε_bb));
    # see :func:`pair_scale_tables`.  For 2 types the lookup compiles to
    # 3 FMAs (bilinear in the type values — no gather); one-hot masks
    # beyond.  Vacant slots stay culled by se = 0.
    eps_scale: tuple = struct.field(pytree_node=False, default=None)
    sigma_scale: tuple = struct.field(pytree_node=False, default=None)
    # Bonds (None = no bonds).  Bonded pairs are matched in-kernel via
    # per-slot partner pids ('bp0'..'bp{bond_slots-1}' attrs) and get the
    # bond interaction INSTEAD of the pair potential — HOOMD's default
    # bond exclusion.  ``bond_kind`` selects the potential (HOOMD
    # PotentialBondFENE / PotentialBondHarmonic parity, SURVEY.md §2b):
    #   "fene":     FENE + built-in WCA (Kremer–Grest); k = fene_k,
    #               r0 = max extension
    #   "harmonic": u = ½ k (r − r0)²; k = fene_k, r0 = rest length
    # bond_slots = max bonds per particle (2 = linear chains; raise it for
    # branched/star topologies).
    fene_k: float = struct.field(pytree_node=False, default=None)
    fene_r0: float = struct.field(pytree_node=False, default=None)
    bond_kind: str = struct.field(pytree_node=False, default="fene")
    bond_slots: int = struct.field(pytree_node=False, default=2)

    @property
    def n_cells(self) -> int:
        cx, cy, cz = self.cells_per_dim
        return cx * cy * cz

    @property
    def n_pad(self) -> int:
        return self.cap * self.n_cells

    @property
    def r_list(self) -> float:
        return self.r_cut + self.skin

    @property
    def has_bonds(self) -> bool:
        return self.fene_k is not None

    @property
    def has_pair_table(self) -> bool:
        return self.eps_scale is not None or self.sigma_scale is not None

    @classmethod
    def create(cls, box_L, n_particles: int, r_cut: float, skin: float = 0.5,
               cap: Optional[int] = None, shift_energy: bool = True,
               fene_k: Optional[float] = None,
               fene_r0: Optional[float] = None,
               uniform_sigma: Optional[float] = None,
               uniform_eps: Optional[float] = None,
               pair_kind: str = "lj",
               bond_kind: str = "fene",
               bond_slots: int = 2,
               eps_scale=None,
               sigma_scale=None,
               tilt=None) -> "PackedSpec":
        L = np.asarray(box_L, np.float64).reshape(-1)
        if L.size == 1:
            L = np.repeat(L, 3)
        r_list = r_cut + skin
        if tilt is not None:
            # triclinic sizing: a fractional cell layer of thickness
            # 1/cpd_d has perpendicular width w_perp_d/cpd_d; the 27-cell
            # roll stencil covers r_list exactly when that width ≥ r_list
            # (HOOMD BoxDim parity — same criterion as its CellList)
            xy, xz, yz = (float(t) for t in np.asarray(tilt).reshape(3))
            h = np.array([[L[0], xy * L[1], xz * L[2]],
                          [0.0, L[1], yz * L[2]],
                          [0.0, 0.0, L[2]]])
            a, b, c = h[:, 0], h[:, 1], h[:, 2]
            vol = abs(np.dot(a, np.cross(b, c)))
            w = np.array([vol / np.linalg.norm(np.cross(b, c)),
                          vol / np.linalg.norm(np.cross(c, a)),
                          vol / np.linalg.norm(np.cross(a, b))])
        else:
            w = L
        cpd = tuple(int(np.floor(wd / r_list)) for wd in w)
        assert min(cpd) >= 3, (
            f"box too small for cell decomposition: cells_per_dim={cpd}; "
            "use the all-pairs engine")
        n_cells = int(np.prod(cpd))
        if cap is None:
            mean_occ = n_particles / n_cells
            # Poisson-tail sizing: multiplicative headroom alone underflows
            # at low mean occupancy (mean 2 × 2.2 → cap 5, which a
            # clustered melt overflows within steps).  mean + 5√mean + 4
            # puts per-cell overflow odds below ~1e-6 even for
            # inhomogeneous fluids; rounded up to a multiple of 4.
            # Perf-critical runs should still set cap
            # from measured occupancy (bench.py does).
            est = mean_occ + 5.0 * np.sqrt(mean_occ) + 4.0
            cap = int(np.ceil(est / 4.0) * 4)
        if eps_scale is not None or sigma_scale is not None:
            assert uniform_eps is None and uniform_sigma is None, (
                "per-type-pair tables need the se/hs per-slot layout "
                "(incompatible with uniform_eps/uniform_sigma)")

        def _tup(t):
            if t is None:
                return None
            a = np.asarray(t, np.float64)
            assert a.ndim == 2 and a.shape[0] == a.shape[1]
            assert np.allclose(a, a.T), "pair tables must be symmetric"
            return tuple(tuple(float(x) for x in row) for row in a)

        assert bond_kind in ("fene", "harmonic"), bond_kind
        return cls(cells_per_dim=cpd, cap=cap, n_real=n_particles,
                   r_cut=r_cut, skin=skin, shift_energy=shift_energy,
                   fene_k=fene_k, fene_r0=fene_r0, bond_kind=bond_kind,
                   uniform_sigma=uniform_sigma, uniform_eps=uniform_eps,
                   pair_kind=pair_kind, bond_slots=bond_slots,
                   eps_scale=_tup(eps_scale), sigma_scale=_tup(sigma_scale))


@struct.dataclass
class PackedState:
    """MD state in slot layout.  All (3, Npad) f32 / (Npad,) vectors."""

    r: jax.Array        # (3, Npad) wrapped positions (vacant: 0)
    v: jax.Array        # (3, Npad)
    f: jax.Array        # (3, Npad) forces at r
    image: jax.Array    # (3, Npad) i32 box-image counters
    ref_r: jax.Array    # (3, Npad) positions at last rebuild
    pid: jax.Array      # (Npad,) i32 original particle id; n_real = vacant
    typ: jax.Array      # (Npad,) i32 type; n_types = vacant sentinel
    slot_of: jax.Array  # (n_real,) i32 current slot of each particle id
    attrs: dict         # per-slot f32 attrs: 'se'=√ε, 'hs'=σ/2, + CV coefs
    box: Box
    potential_energy: jax.Array
    virial: jax.Array   # (3,) diagonal virial

    @property
    def n_pad(self) -> int:
        return self.pid.shape[0]


def _cell_id_packed(r: jax.Array, box: Box, spec: PackedSpec) -> jax.Array:
    """Linear cell id per slot/particle from (3, M) coordinates.

    Binning is FRACTIONAL (lattice coordinates), so the same cell grid
    covers orthorhombic and tilted cells: a cell is a parallelepiped of
    fractional thickness 1/cpd_d whose perpendicular width
    w_perp_d / cpd_d ≥ r_list is guaranteed by PackedSpec sizing."""
    cpd = np.asarray(spec.cells_per_dim, np.int32)
    f = _frac3(r, box)
    out = jnp.zeros(r.shape[1], jnp.int32)
    for d in range(3):
        c = jnp.clip(jnp.floor((f[d] + 0.5) * cpd[d]).astype(jnp.int32),
                     0, cpd[d] - 1)
        out = out * cpd[d] + c
    return out


def _slot_assignment(cid: jax.Array, valid: jax.Array, spec: PackedSpec):
    """slot = rank·C + cell for valid entries; Npad (drop) for the rest.
    Rank within a cell comes from a 1-D sort — deterministic binning."""
    m = cid.shape[0]
    key = jnp.where(valid, cid, jnp.int32(spec.n_cells))
    order = jnp.argsort(key)          # valid entries grouped by cell
    sorted_key = key[order]
    rank = jnp.arange(m, dtype=jnp.int32) - jnp.searchsorted(
        sorted_key, sorted_key, side="left").astype(jnp.int32)
    # slot for the j-th sorted entry
    slot_sorted = jnp.where(
        (sorted_key < spec.n_cells) & (rank < spec.cap),
        rank * spec.n_cells + sorted_key,
        spec.n_pad,
    )
    overflow = jnp.any((sorted_key < spec.n_cells) & (rank >= spec.cap))
    # back to input order
    slot = jnp.zeros(m, jnp.int32).at[order].set(slot_sorted)
    return slot, overflow


def _wrap_state(state: PackedState) -> PackedState:
    """Wrap coordinates into the box, updating image counters.

    Called ONLY inside pack/repack: between repacks coordinates drift
    continuously (a per-step wrap would teleport a coordinate by ±L while
    the slot cell still implies the old side — see integrate/packed.py).
    Image counters count LATTICE VECTORS (fractional wrap under tilt,
    matching core/box.wrap)."""
    shift = jnp.floor(_frac3(state.r, state.box) + 0.5)
    return state.replace(
        r=state.r - _cart3(shift, state.box),
        image=state.image + shift.astype(jnp.int32),
    )


def _scatter(x: jax.Array, slot: jax.Array, n_pad: int, fill) -> jax.Array:
    out = jnp.full((n_pad + 1,), fill, x.dtype)
    return out.at[slot].set(x, mode="drop")[:n_pad]


def _scatter_rows(cols: list[jax.Array], slot: jax.Array, n_pad: int) -> list[jax.Array]:
    """Permute many (M,) columns by one ROW scatter of an (M, W) matrix.

    One row scatter of a (M, W) matrix instead of W element scatters.
    Integer columns are converted BY VALUE to f32 (exact below 2^24 —
    pids, images and types all qualify); never bitcast: small-int bit
    patterns are f32 denormals, which a device may flush to zero.
    Dropped (invalid) rows leave zeros.
    """
    w = len(cols)
    wpad = ((w + 7) // 8) * 8
    mats = [c.astype(jnp.float32) for c in cols]
    mat = jnp.stack(mats + [jnp.zeros_like(mats[0])] * (wpad - w), axis=1)  # (M, Wpad)
    out = jnp.zeros((n_pad + 1, wpad), jnp.float32).at[slot].set(mat, mode="drop")
    out = out[:n_pad]
    return [out[:, i].astype(c.dtype) for i, c in enumerate(cols)]


def pack(
    pos: np.ndarray,            # (N, 3) particle-order positions
    box: Box,
    spec: PackedSpec,
    types: jax.Array,           # (N,) i32
    eps_i: jax.Array,           # (N,) per-particle ε (Lorentz–Berthelot)
    sigma_i: jax.Array,         # (N,)
    vel: Optional[jax.Array] = None,
    image: Optional[jax.Array] = None,
    extra_attrs: Optional[dict] = None,   # name -> (N,) f32 (e.g. CV coefs)
) -> tuple[PackedState, jax.Array]:
    """Initial build from particle-order arrays.  Returns (state, overflow)."""
    n = spec.n_real
    r_in = jnp.asarray(pos, jnp.float32).T            # (3, N)
    v_in = (jnp.zeros_like(r_in) if vel is None
            else jnp.asarray(vel, jnp.float32).T)
    im_in = (jnp.zeros((3, n), jnp.int32) if image is None
             else jnp.asarray(image, jnp.int32).T)
    # wrap into the box (image counters track lattice-vector shifts)
    shift_in = jnp.floor(_frac3(r_in, box) + 0.5)
    r_in = r_in - _cart3(shift_in, box)
    im_in = im_in + shift_in.astype(jnp.int32)
    cid = _cell_id_packed(r_in, box, spec)
    slot, overflow = _slot_assignment(cid, jnp.ones(n, bool), spec)
    npad = spec.n_pad
    attr_names = ["se", "hs"] + sorted((extra_attrs or {}).keys())
    attr_cols = [jnp.sqrt(eps_i), 0.5 * sigma_i] + [
        jnp.asarray((extra_attrs or {})[k], jnp.float32)
        for k in sorted((extra_attrs or {}).keys())]
    cols = (
        [r_in[d] for d in range(3)] + [v_in[d] for d in range(3)]
        + [im_in[d] for d in range(3)]
        + [jnp.arange(1, n + 1, dtype=jnp.int32),      # pid+1 (0 ⇒ vacant)
           types.astype(jnp.int32)]
        + attr_cols
    )
    out = _scatter_rows(cols, slot, npad)
    r = jnp.stack(out[0:3])
    pid1 = out[9]
    typ_raw = out[10]
    valid = pid1 > 0
    if spec.uniform_eps is not None:
        r = jnp.where(valid[None, :], r, jnp.float32(VACANT_X))
    # vacant-type sentinel = n_types, derived tracably (jit-safe)
    n_types = (jnp.max(types).astype(jnp.int32) + 1 if types.shape[0]
               else jnp.int32(1))
    state = PackedState(
        r=r,
        v=jnp.stack(out[3:6]),
        f=jnp.zeros((3, npad), jnp.float32),
        image=jnp.stack(out[6:9]),
        ref_r=r,
        pid=jnp.where(valid, pid1 - 1, jnp.int32(n)),
        typ=jnp.where(valid, typ_raw, jnp.int32(n_types)),
        slot_of=slot,
        attrs=dict(zip(attr_names, out[11:])),
        box=box,
        potential_energy=jnp.float32(0.0),
        virial=jnp.zeros(3, jnp.float32),
    )
    return state, overflow


def pack_host(
    pos: np.ndarray,
    box: Box,
    spec: PackedSpec,
    types,
    eps_i,
    sigma_i,
    vel=None,
    image=None,
    extra_attrs=None,
) -> tuple[PackedState, bool]:
    """NumPy twin of :func:`pack` — the initial build runs entirely on
    the host: one NumPy sort and one transfer, no device compile.
    Packing happens once per run; the sort-free incremental repack
    handles all subsequent migrations on-device.  Mirrors pack()'s f32
    arithmetic and stable ordering.
    """
    n = spec.n_real
    cpd = np.asarray(spec.cells_per_dim, np.int32)
    C, cap, npad = spec.n_cells, spec.cap, spec.n_pad
    r = np.asarray(pos, np.float32).T.copy()            # (3, N)
    v = (np.zeros_like(r) if vel is None
         else np.asarray(vel, np.float32).T)
    im = (np.zeros((3, n), np.int32) if image is None
          else np.asarray(image, np.int32).T)
    # fractional wrap + bin (numpy twin of _frac3/_cart3: identical f32
    # math in the orthorhombic case, h/h⁻¹ matmuls under tilt)
    if box.tilt is None:
        L = np.asarray(box.L, np.float32).reshape(3)
        hmat = np.diag(L)
        hinv = np.diag(1.0 / L)
    else:
        hmat = np.asarray(h_matrix(box), np.float32)
        hinv = np.asarray(h_inverse(box), np.float32)
    if box.tilt is None:
        f = r / L[:, None]
    else:
        f = (hinv @ r).astype(np.float32)
    shift = np.floor(f + np.float32(0.5))
    if box.tilt is None:
        r = r - L[:, None] * shift
    else:
        r = (r - hmat @ shift).astype(np.float32)
        f = (hinv @ r).astype(np.float32)
    im = im + shift.astype(np.int32)
    cid = np.zeros(n, np.int64)
    for d in range(3):
        if box.tilt is None:
            frac = r[d] / L[d] + np.float32(0.5)
        else:
            frac = f[d] + np.float32(0.5)
        c = np.clip(np.floor(frac * cpd[d]).astype(np.int64), 0, cpd[d] - 1)
        cid = cid * cpd[d] + c
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    rank = np.arange(n) - np.searchsorted(sorted_cid, sorted_cid, "left")
    slot_sorted = np.where(rank < cap, rank * C + sorted_cid, npad)
    overflow = bool(np.any(rank >= cap))
    slot = np.empty(n, np.int64)
    slot[order] = slot_sorted

    types = np.asarray(types, np.int32)
    names = sorted((extra_attrs or {}).keys())
    attr_cols = ([np.sqrt(np.asarray(eps_i, np.float32)),
                  0.5 * np.asarray(sigma_i, np.float32)]
                 + [np.asarray((extra_attrs or {})[k], np.float32)
                    for k in names])

    def scat(col, fill=0.0, dtype=np.float32):
        out = np.full(npad + 1, fill, dtype)
        out[slot] = col
        return out[:npad]

    r_o = np.stack([scat(r[d]) for d in range(3)])
    pid1 = scat(np.arange(1, n + 1, dtype=np.int32), 0, np.int32)
    valid = pid1 > 0
    if spec.uniform_eps is not None:
        r_o = np.where(valid[None, :], r_o, np.float32(VACANT_X))
    n_types = int(types.max()) + 1 if n else 1
    # assemble in numpy, ONE device_put for the whole pytree
    state_np = PackedState(
        r=r_o,
        v=np.stack([scat(v[d]) for d in range(3)]),
        f=np.zeros((3, npad), np.float32),
        image=np.stack([scat(im[d], 0, np.int32) for d in range(3)]),
        ref_r=r_o,
        pid=np.where(valid, pid1 - 1, n).astype(np.int32),
        typ=np.where(valid, scat(types, 0, np.int32),
                     n_types).astype(np.int32),
        slot_of=slot.astype(np.int32),
        attrs={k: scat(c) for k, c in zip(["se", "hs"] + names, attr_cols)},
        box=box,
        potential_energy=np.float32(0.0),
        virial=np.zeros(3, np.float32),
    )
    return jax.device_put(state_np), overflow


def repack(state: PackedState, spec: PackedSpec) -> tuple[PackedState, jax.Array]:
    """Rebuild: migrate slots to current cells.  Returns (state, overflow)."""
    state = _wrap_state(state)
    valid_in = state.pid < spec.n_real
    cid = _cell_id_packed(state.r, state.box, spec)
    slot, overflow = _slot_assignment(cid, valid_in, spec)
    npad = spec.n_pad
    attr_names = sorted(state.attrs.keys())
    cols = (
        [state.r[d] for d in range(3)] + [state.v[d] for d in range(3)]
        + [state.f[d] for d in range(3)] + [state.image[d] for d in range(3)]
        + [jnp.where(valid_in, state.pid + 1, 0), state.typ]
        + [state.attrs[k] for k in attr_names]
    )
    out = _scatter_rows(cols, slot, npad)
    r = jnp.stack(out[0:3])
    pid1 = out[12]
    valid = pid1 > 0
    if spec.uniform_eps is not None:
        r = jnp.where(valid[None, :], r, jnp.float32(VACANT_X))
    sentinel_typ = jnp.max(state.typ)
    pid = jnp.where(valid, pid1 - 1, jnp.int32(spec.n_real))
    # vacant slots have pid == n_real (out of bounds) → dropped by the mode
    slot_of = jnp.zeros(spec.n_real, jnp.int32).at[state.pid].set(
        slot, mode="drop")
    return state.replace(
        r=r,
        v=jnp.stack(out[3:6]),
        f=jnp.stack(out[6:9]),
        image=jnp.stack(out[9:12]),
        ref_r=r,
        pid=pid,
        typ=jnp.where(valid, out[13], sentinel_typ),
        slot_of=slot_of,
        attrs=dict(zip(attr_names, out[14:])),
    ), overflow


def _cell_coords_static(spec: PackedSpec):
    """Static per-cell 3-D coordinates of each linear cell id, (3, C)."""
    cx, cy, cz = spec.cells_per_dim
    ix, iy, iz = np.unravel_index(np.arange(spec.n_cells), (cx, cy, cz))
    return np.stack([ix, iy, iz]).astype(np.int32)


def repack_incremental(state: PackedState, spec: PackedSpec
                       ) -> tuple[PackedState, jax.Array]:
    """Sort-free rebuild (the production path).

    No sort: between rebuilds a particle moves at most
    one cell (guaranteed by the half-skin criterion for any sane skin), so
    the new slot assignment decomposes over the 27 cell offsets into pure
    rolls + cumsums:

      rank(p) = Σ_{o'<o} arrivals_{o'}(c+o)  +  rank of p among the
                particles leaving its old column via the same offset o,

    where ``arrivals_o`` is a per-cell count (a (C,) reduction rolled by o).
    Deterministic (ordered by (offset, old slot)); zero sorts, zero gathers.
    A particle that moved >1 cell is dropped and flagged (the MD loop's
    skin check fires first in any physical run).

    Returns (state, bad) where bad = capacity overflow OR lost particle.
    """
    state = _wrap_state(state)
    valid = state.pid < spec.n_real
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    dims = (cx, cy, cz)
    cpd = np.asarray(dims, np.int32)
    old_coords = _cell_coords_static(spec)                  # (3, C) static

    # new cell coords per slot from FRACTIONAL positions, (3, Npad)
    f3 = _frac3(state.r, state.box)
    new_c = []
    for d in range(3):
        frac = f3[d] + 0.5
        c = jnp.clip(jnp.floor(frac * cpd[d]).astype(jnp.int32), 0, cpd[d] - 1)
        new_c.append(c.reshape(cap, C))

    view3 = lambda a: a.reshape(*dims)
    roll3 = lambda a, o: jnp.roll(view3(a), shift=o, axis=(0, 1, 2)).reshape(C)

    valid2 = valid.reshape(cap, C)
    slot_new = jnp.full((cap, C), spec.n_pad, jnp.int32)
    matched = jnp.zeros((cap, C), bool)
    base = jnp.zeros((C,), jnp.int32)   # arrivals so far per DESTINATION cell
    rank_new = jnp.zeros((cap, C), jnp.int32)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                o = (ox, oy, oz)
                m = valid2
                for d, od in enumerate(o):
                    tgt = (old_coords[d] + od) % dims[d]     # (C,) static np
                    m = m & (new_c[d] == jnp.asarray(tgt)[None, :])
                # rank within the (offset, source-column) group
                grp_rank = jnp.cumsum(m, axis=0, dtype=jnp.int32) - m
                # base offset: arrivals from earlier offsets at my destination
                # = base(c+o), brought to the source frame by rolling by -o
                base_src = roll3(base, (-ox, -oy, -oz))[None, :]
                r_new = base_src + grp_rank
                # destination linear cell, static per source cell
                dest_lin = (
                    ((old_coords[0] + ox) % cx) * cy
                    + (old_coords[1] + oy) % cy
                ) * cz + (old_coords[2] + oz) % cz
                s = r_new * C + jnp.asarray(dest_lin.astype(np.int32))[None, :]
                ok = m & (r_new < cap)
                slot_new = jnp.where(ok, s, slot_new)
                matched = matched | m
                # arrivals via this offset, destination-indexed
                col_cnt = jnp.sum(m, axis=0, dtype=jnp.int32)     # per source
                base = base + roll3(col_cnt, o)
                # materialize per offset: left whole, the GPU compiler
                # fuses all 27 offsets into one reduction and spends
                # minutes compiling it (4.5 min at 62.5k on an H100)
                slot_new, matched, base = jax.lax.optimization_barrier(
                    (slot_new, matched, base))
    lost = jnp.any(valid2 & ~matched)
    overflow = jnp.any(base > cap) | lost
    slot = slot_new.reshape(-1)

    attr_names = sorted(state.attrs.keys())
    cols = (
        [state.r[d] for d in range(3)] + [state.v[d] for d in range(3)]
        + [state.f[d] for d in range(3)] + [state.image[d] for d in range(3)]
        + [jnp.where(valid, state.pid + 1, 0), state.typ]
        + [state.attrs[k] for k in attr_names]
    )
    out = _scatter_rows(cols, slot, spec.n_pad)
    r = jnp.stack(out[0:3])
    pid1 = out[12]
    valid_new = pid1 > 0
    if spec.uniform_eps is not None:
        r = jnp.where(valid_new[None, :], r, jnp.float32(VACANT_X))
    slot_of = jnp.zeros(spec.n_real, jnp.int32).at[state.pid].set(
        slot, mode="drop")
    return state.replace(
        r=r,
        v=jnp.stack(out[3:6]),
        f=jnp.stack(out[6:9]),
        image=jnp.stack(out[9:12]),
        ref_r=r,
        pid=jnp.where(valid_new, pid1 - 1, jnp.int32(spec.n_real)),
        typ=jnp.where(valid_new, out[13], jnp.max(state.typ)),
        slot_of=slot_of,
        attrs=dict(zip(attr_names, out[14:])),
    ), overflow


def needs_repack(state: PackedState, spec: PackedSpec) -> jax.Array:
    """Half-skin displacement criterion over valid slots (minimum image
    by fractional rounding — exact for sub-skin displacements)."""
    dr = state.r - state.ref_r
    dr = dr - _cart3(jnp.round(_frac3(dr, state.box)), state.box)
    d2 = jnp.sum(dr * dr, axis=0)
    d2 = jnp.where(state.pid < spec.n_real, d2, 0.0)
    return jnp.max(d2) > (0.5 * spec.skin) ** 2


def _roll_offsets(spec: PackedSpec):
    """Static per-offset (roll amounts, unit shift vectors) for all 27."""
    cx, cy, cz = spec.cells_per_dim
    C = spec.n_cells
    ix, iy, iz = np.unravel_index(np.arange(C), (cx, cy, cz))
    out = []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                # unit shift: +1 if neighbor cell wraps past the high edge
                sx = ((ix + ox) // cx).astype(np.float32)
                sy = ((iy + oy) // cy).astype(np.float32)
                sz = ((iz + oz) // cz).astype(np.float32)
                out.append(((ox, oy, oz), np.stack([sx, sy, sz])))
    return out


def pair_scale_tables(eps_table, sigma_table=None):
    """HOOMD-style TARGET tables → (eps_scale, sigma_scale, eps_diag,
    sigma_diag): the static scaling tables for :class:`PackedSpec` plus
    the per-TYPE diagonals to build ``eps_i``/``sigma_i`` from
    (``eps_i = eps_diag[types]``).  ε targets must be positive (use the
    soft pair for athermal species)."""
    e = np.asarray(eps_table, np.float64)
    assert np.all(e > 0), "eps table entries must be positive"
    se = np.sqrt(np.diag(e))
    eps_scale = e / np.outer(se, se)
    if sigma_table is None:
        return (eps_scale, None, np.diag(e).astype(np.float32), None)
    s = np.asarray(sigma_table, np.float64)
    hs = 0.5 * np.diag(s)
    sigma_scale = s / np.add.outer(hs, hs)
    return (eps_scale, sigma_scale, np.diag(e).astype(np.float32),
            np.diag(s).astype(np.float32))


def _scale_fn(table):
    """Static symmetric (nt, nt) scale table → traced ``f(ti, tj) -> k``
    with ti/tj the f32 type values.  nt ≤ 2 compiles to ≤3 FMAs
    (bilinear interpolation is exact on {0, 1}²); one-hot masks beyond.
    Out-of-range types (the vacant sentinel nt) yield a finite value
    (bilinear) or 0 (one-hot) — vacancy is culled by se = 0 regardless."""
    t = np.asarray(table, np.float64)
    nt = t.shape[0]
    if np.allclose(t, t[0, 0]):
        c = float(t[0, 0])
        return lambda ti, tj: c
    if nt == 2:
        c0 = float(t[0, 0])
        c1 = float(t[0, 1] - t[0, 0])
        c2 = float(t[1, 1] - 2.0 * t[0, 1] + t[0, 0])
        return lambda ti, tj: c0 + c1 * (ti + tj) + c2 * (ti * tj)

    def one_hot(ti, tj):
        k = jnp.float32(0.0)
        for a in range(nt):
            row = jnp.float32(0.0)
            for b in range(nt):
                row = row + float(t[a, b]) * (tj == b)
            k = k + (ti == a) * row
        return k

    return one_hot


def pair_scales_for(spec: "PackedSpec"):
    """(k_eps(ti,tj), k_sig(ti,tj)) traced scale fns, or (None, None)."""
    ke = _scale_fn(spec.eps_scale) if spec.eps_scale is not None else None
    ks = (_scale_fn(spec.sigma_scale)
          if spec.sigma_scale is not None else None)
    return ke, ks


def _fene_wca_pair(r2s, eps, sig, spec):
    """Bonded-pair energy/coef; replaces the plain pair term for bonded
    pairs (HOOMD bond-exclusion convention).  Dispatches on
    ``spec.bond_kind`` at trace time: FENE + built-in WCA (Kremer–Grest)
    or the harmonic spring u = ½k(r−r0)² (matches ops/bonds.py)."""
    r0 = spec.fene_r0
    k = spec.fene_k
    if spec.bond_kind == "harmonic":
        r = jnp.sqrt(r2s)
        e = 0.5 * k * (r - r0) ** 2
        coef = -k * (r - r0) / r
        return e, coef
    x = jnp.minimum(r2s / (r0 * r0), 0.99)
    e_f = -0.5 * k * r0 * r0 * jnp.log1p(-x)
    coef_f = -k / (1.0 - x)
    rc2w = (2.0 ** (1.0 / 3.0)) * sig * sig
    in_w = r2s < rc2w
    s2 = sig * sig / r2s
    s6 = s2 * s2 * s2
    e_w = jnp.where(in_w, 4.0 * eps * (s6 * s6 - s6) + eps, 0.0)
    coef_w = jnp.where(in_w, 4.0 * eps * (12.0 * s6 * s6 - 6.0 * s6) / r2s, 0.0)
    return e_f + e_w, coef_f + coef_w


def packed_lj_force(state: PackedState, spec: PackedSpec,
                    cell_mask: Optional[jax.Array] = None,
                    j_block: Optional[int] = None) -> PackedState:
    """LJ pair forces via the 27-offset roll method (see module docstring).

    Per-slot Lorentz–Berthelot parameters: ε_ij = se_i·se_j (se=√ε),
    σ_ij = hs_i + hs_j (hs=σ/2).  Vacant slots have se=0 ⇒ zero coupling.

    ``cell_mask`` ((C,) 0/1) restricts the energy/virial sums to pairs
    whose i-cell is masked in — used by the spatial-sharding path so halo
    cells contribute forces to their neighbors but are not double-counted
    in the replicated scalars (parallel/spatial.py).
    """
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    view = lambda a: a.reshape(cap, cx, cy, cz)
    x4 = [view(state.r[d].reshape(cap, C)) for d in range(3)]
    se4 = view(state.attrs["se"].reshape(cap, C))
    hs4 = view(state.attrs["hs"].reshape(cap, C))
    rc2 = jnp.float32(spec.r_cut**2)

    # j-axis chunking: the full (cap, cap, C) pair block OOMs at ~1M
    # particles with generous caps; process j in slabs of j_block rows
    # via fori_loop (identical math, bounded peak memory).  Auto-enable
    # past 2^26 pair elements.
    if j_block is None and cap * cap * C > 2**26:
        j_block = max(8, (2**26 // (cap * C)) // 8 * 8)
    jb = cap if j_block is None or j_block >= cap else j_block
    n_chunks = -(-cap // jb)
    cap_p = n_chunks * jb

    fx = [jnp.zeros((cap, C), jnp.float32) for _ in range(3)]
    e_tot = jnp.float32(0.0)
    w_tot = jnp.zeros(3, jnp.float32)
    xi = [x4[d].reshape(cap, C)[None, :, :] for d in range(3)]       # (1, capi, C)
    se_i = se4.reshape(cap, C)[None, :, :]
    hs_i = hs4.reshape(cap, C)[None, :, :]
    k_eps, k_sig = pair_scales_for(spec)
    if spec.has_pair_table:
        ty4 = view(state.typ.astype(jnp.float32).reshape(cap, C))
        ty_i = ty4.reshape(cap, C)[None, :, :]
    if spec.has_bonds:
        pid4 = view(state.pid.astype(jnp.float32).reshape(cap, C))
        bp_i = [state.attrs[f"bp{k}"].reshape(cap, C)[None, :, :]
                for k in range(spec.bond_slots)]

    def pair_block(xj, se_j, hs_j, pid_j, ty_j=None):
        """(B, 1-broadcast) partner rows vs all i: returns (coef, dx, r2).
        xj/se_j/hs_j/pid_j/ty_j are (B, 1, C)."""
        dx = []
        r2 = jnp.zeros((xj[0].shape[0], cap, C), jnp.float32)
        for d in range(3):
            c = xi[d] - xj[d]
            dx.append(c)
            r2 = r2 + c * c
        eps = se_i * se_j
        sig = hs_i + hs_j
        if k_eps is not None:
            eps = eps * k_eps(ty_i, ty_j)
        if k_sig is not None:
            sig = sig * k_sig(ty_i, ty_j)
        inside = (r2 < rc2) & (r2 > 1e-12)
        r2s = jnp.where(inside, r2, 1.0)
        if spec.pair_kind == "soft":
            # DPD-conservative: u = (A·rc/2)(1−r/rc)², F = A(1−r/rc) r̂
            rc = jnp.float32(spec.r_cut)
            r_ = jnp.sqrt(r2s)
            x = 1.0 - r_ / rc
            e = 0.5 * eps * rc * x * x
            coef = eps * x / r_
        else:
            s2 = sig * sig / r2s
            s6 = s2 * s2 * s2
            e = 4.0 * eps * (s6 * s6 - s6)
            if spec.shift_energy:
                sc2 = sig * sig / rc2
                sc6 = sc2 * sc2 * sc2
                e = e - 4.0 * eps * (sc6 * sc6 - sc6)
            coef = 4.0 * eps * (12.0 * s6 * s6 - 6.0 * s6) / r2s
        e = jnp.where(inside, e, 0.0)
        coef = jnp.where(inside, coef, 0.0)
        if spec.has_bonds:
            # bp attrs store partner_pid+1 (0 = none) so zero-filled vacant
            # slots can never match particle 0.  Bond matching is NOT gated
            # on the pair r_cut: a bond stretched past r_cut must keep its
            # full FENE+WCA interaction (the pair cutoff only gates the
            # plain LJ term), else the chain silently scissions.
            match = bp_i[0] == pid_j
            for bpk in bp_i[1:]:
                match = match | (bpk == pid_j)
            bonded = match & (r2 > 1e-12)
            r2b = jnp.where(bonded, r2, 1.0)
            e_b, coef_b = _fene_wca_pair(r2b, eps, sig, spec)
            e = jnp.where(bonded, e_b, e)
            coef = jnp.where(bonded, coef_b, coef)
        if cell_mask is not None:
            e = e * cell_mask[None, None, :]
            wc = coef * cell_mask[None, None, :]
        else:
            wc = coef  # coef is zero outside active pairs
        fc = [jnp.sum(coef * dx[d], axis=0) for d in range(3)]
        # per-axis (diagonal) virial: Σ coef·dx_d² (reference NPT stress)
        w3 = jnp.stack([jnp.sum(wc * dx[d] * dx[d]) for d in range(3)])
        return fc, jnp.sum(e), w3

    for (o, ushift) in _roll_offsets(spec):
        roll = lambda a: jnp.roll(a, shift=(-o[0], -o[1], -o[2]), axis=(1, 2, 3))
        shift = shift_rows_cart(ushift, state.box)                    # (3, C)
        rolled_x = [roll(x4[d]).reshape(cap, C) + shift[d][None, :]
                    for d in range(3)]
        rolled_se = roll(se4).reshape(cap, C)
        rolled_hs = roll(hs4).reshape(cap, C)
        rolled_pid = (roll(pid4).reshape(cap, C) + 1.0
                      if spec.has_bonds else None)
        rolled_ty = (roll(ty4).reshape(cap, C)
                     if spec.has_pair_table else None)
        if jb >= cap:
            fc, e, w = pair_block(
                [rx[:, None, :] for rx in rolled_x],
                rolled_se[:, None, :], rolled_hs[:, None, :],
                rolled_pid[:, None, :] if rolled_pid is not None else None,
                rolled_ty[:, None, :] if rolled_ty is not None else None)
            for d in range(3):
                fx[d] = fx[d] + fc[d]
            e_tot = e_tot + e
            w_tot = w_tot + w
            continue
        if cap_p != cap:
            # pad rows: se=0 keeps pair terms zero; pid pads to the vacant
            # sentinel so bond matching can't fire
            padrow = lambda a, f=0.0: jnp.pad(
                a, ((0, cap_p - cap), (0, 0)), constant_values=f)
            rolled_x = [padrow(rx) for rx in rolled_x]
            rolled_se = padrow(rolled_se)
            rolled_hs = padrow(rolled_hs)
            if rolled_pid is not None:
                rolled_pid = padrow(rolled_pid, float(spec.n_real + 1))
            if rolled_ty is not None:
                rolled_ty = padrow(rolled_ty)

        def chunk(jc, carry):
            f3, e_a, w_a = carry
            sl = lambda a: jax.lax.dynamic_slice_in_dim(
                a, jc * jb, jb, 0)[:, None, :]
            fc, e, w = pair_block(
                [sl(rx) for rx in rolled_x], sl(rolled_se), sl(rolled_hs),
                sl(rolled_pid) if rolled_pid is not None else None,
                sl(rolled_ty) if rolled_ty is not None else None)
            return ([f3[d] + fc[d] for d in range(3)], e_a + e, w_a + w)

        (fc3, e, w) = jax.lax.fori_loop(
            0, n_chunks, chunk,
            ([jnp.zeros((cap, C), jnp.float32) for _ in range(3)],
             jnp.float32(0.0), jnp.zeros(3, jnp.float32)))
        for d in range(3):
            fx[d] = fx[d] + fc3[d]
        e_tot = e_tot + e
        w_tot = w_tot + w

    force = jnp.stack([f.reshape(-1) for f in fx])
    return state.replace(
        f=force,
        potential_energy=0.5 * e_tot,
        virial=0.5 * w_tot,
    )


def assert_no_vacant_drift(state: PackedState, spec: PackedSpec) -> None:
    """Test/debug helper for the LOAD-BEARING sentinel invariant: in
    uniform-eps (lean) mode every vacant slot must sit at the EXACT
    ``VACANT_X`` coordinate — the pair paths cull vacancy purely by r²
    tests that rely on it (see packed_triton._pair_terms).  Every
    pack/repack variant and every packed integrator must re-pin vacant
    slots (``integrate.packed._pin_vacant``); a future integrator author
    WILL forget it (VERDICT r3 weak #7) — call this from their tests.
    No-op outside sentinel mode.  Host-side (not for jit)."""
    if spec.uniform_eps is None:
        return
    vac = np.asarray(jax.device_get(state.pid)) >= spec.n_real
    r = np.asarray(jax.device_get(state.r))[:, vac]
    bad = (r != np.float32(VACANT_X)).sum()
    assert bad == 0, (
        f"{bad} vacant-slot coordinates drifted off the VACANT_X "
        f"sentinel — an integrator or repack forgot _pin_vacant")


def unpack_positions(state: PackedState, spec: PackedSpec) -> jax.Array:
    """(N, 3) particle-order positions (host/diagnostics; uses a gather —
    NOT for the hot loop)."""
    r = state.r[:, state.slot_of]     # (3, N)
    return r.T


def packed_temperature(state: PackedState, spec: PackedSpec,
                       mass: float = 1.0) -> jax.Array:
    valid = (state.pid < spec.n_real).astype(jnp.float32)
    ke = 0.5 * mass * jnp.sum((state.v * state.v) * valid[None, :])
    dof = max(3 * spec.n_real - 3, 3)
    return 2.0 * ke / dof


def bond_partner_attrs(bonds: np.ndarray, n: int, slots: int = 2) -> dict:
    """Per-particle FENE partner attrs for the packed engine.

    ``slots`` = max bonds per particle (match ``PackedSpec.bond_slots``):
    2 covers bead-spring chains; raise it for branched/star topologies.
    Encoded as partner_pid+1 with 0 = no partner (vacant-safe)."""
    bp = np.zeros((n, slots), np.float32)
    cnt = np.zeros(n, np.int32)
    for a, b in np.asarray(bonds):
        for x, y in ((a, b), (b, a)):
            if cnt[x] >= slots:
                raise ValueError(
                    f"particle {x} has more than {slots} bonds; raise "
                    "bond_slots (PackedSpec + bond_partner_attrs)")
            bp[x, cnt[x]] = y + 1
            cnt[x] += 1
    return {f"bp{k}": bp[:, k] for k in range(slots)}
