"""Pair-force kernel for the packed cell layout, in Pallas through Triton.

The same forces as :func:`ops.packed.packed_lj_force` (the XLA roll
sweep), computed by one GPU kernel that reads neighbour-cell columns by
index instead of writing rolled copies of the slot arrays.

**Work split.**  The flat slot axis (``slot = rank·C + cell``) is cut
into blocks of ``block`` consecutive slots: one rank, ``block``
consecutive cells.  One program owns one block; each lane owns one
i-slot and keeps its force (and, with ``with_energy``, its energy and
diagonal virial) in registers.  The loop over the 27 neighbour offsets
and over the j-ranks runs inside the program, so no sum crosses programs
and the kernel writes each output element exactly once: the result is
deterministic.  Every unordered pair is visited from both sides (no
Newton halving), which doubles the pair arithmetic but needs no second
pass and no atomics.

**Neighbour columns.**  A static (27, C) table gives each cell's
neighbour cell per offset, and a (27, 3, C) table its periodic image
shift, both built at trace time from ``spec.cells_per_dim``
(:func:`neighbor_cells`); the shift rows go through
:func:`ops.packed.shift_rows_cart`, so triclinic boxes work unchanged.

**Skipping vacancy.**  ``occ[c]`` = 1 + the highest occupied rank of
cell c.  For each offset the j-loop stops at the block's largest
neighbour ``occ``, and a block with no occupied i-slot does no work.
Vacant slots are still culled inside the loop exactly as in the XLA
path (√ε = 0, or the coordinate sentinel in ``uniform_eps`` mode), so
these bounds only skip work that would contribute zero.

``interpret=True`` runs the kernel through the Pallas interpreter (the
CPU tests); nothing sets it from the platform.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .packed import (PackedSpec, PackedState, VACANT_X, _fene_wca_pair,
                     pair_scales_for, packed_lj_force, shift_rows_cart)

PAIR_PATHS = ("triton", "xla")
NUM_WARPS = 2       # with block=64: one slot per thread


def choose_pair_path(spec: PackedSpec, path=None) -> str:
    """The one place that picks the pair-force implementation.

    ``path`` ("triton" or "xla") overrides the choice.  Otherwise the GPU
    gets the Triton kernel for the LJ pair and every other platform or
    pair kind the XLA roll sweep.  There is no fallback: a chosen kernel
    that fails to lower fails the run."""
    if path is None:
        path = ("triton" if jax.default_backend() == "gpu"
                and spec.pair_kind == "lj" else "xla")
    if path not in PAIR_PATHS:
        raise ValueError(f"pair path must be one of {PAIR_PATHS}: {path!r}")
    if path == "triton" and spec.pair_kind != "lj":
        raise ValueError(f"the Triton pair kernel serves the LJ pair only "
                         f"(pair_kind={spec.pair_kind!r})")
    return path


def pair_force(state: PackedState, spec: PackedSpec, path: str,
               with_energy: bool = True, cell_mask=None,
               interpret: bool = False) -> PackedState:
    """Dispatch to the chosen pair path.  The XLA sweep always reduces
    energy and virial; the kernel only when ``with_energy``."""
    if path == "xla":
        return packed_lj_force(state, spec, cell_mask=cell_mask)
    return packed_lj_force_triton(state, spec, with_energy=with_energy,
                                  cell_mask=cell_mask, interpret=interpret)


@functools.lru_cache(maxsize=None)
def neighbor_cells(cells_per_dim: tuple):
    """Static (27, C) neighbour-cell ids and (27, 3, C) lattice wrap counts.

    Offsets run in the order of ``ops.packed._roll_offsets``: row o holds,
    for every cell c, the cell at c + (ox, oy, oz) modulo the grid, and
    the unit image shift (+1 where the neighbour wraps past the high
    edge, −1 past the low edge)."""
    cx, cy, cz = cells_per_dim
    ix, iy, iz = np.unravel_index(np.arange(cx * cy * cz), (cx, cy, cz))
    nb, ush = [], []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                jx, jy, jz = ix + ox, iy + oy, iz + oz
                nb.append(((jx % cx) * cy + jy % cy) * cz + jz % cz)
                ush.append(np.stack([jx // cx, jy // cy, jz // cz]))
    return (np.stack(nb).astype(np.int32),
            np.stack(ush).astype(np.float32))


def _pair_terms(r2, eps, sig, rc2, spec, with_energy, gate_eps):
    """LJ force coefficient (and shifted energy) for one candidate pair
    per lane; zero outside (r² < rc², r² > 0)."""
    inside = (r2 < rc2) & (r2 > 1e-12)
    if gate_eps:
        # vacant slots (√ε = 0) can drift onto each other; gating before
        # the power chain keeps 0·inf out of the sums
        inside = inside & (eps > 0.0)
    inv = jnp.where(inside, 1.0 / jnp.where(inside, r2, 1.0), 0.0)
    s2 = sig * sig * inv
    s6 = s2 * s2 * s2
    coef = 4.0 * eps * (12.0 * s6 * s6 - 6.0 * s6) * inv
    e = None
    if with_energy:
        e = 4.0 * eps * (s6 * s6 - s6)
        if spec.shift_energy:
            sc2 = sig * sig * (1.0 / rc2)
            sc6 = sc2 * sc2 * sc2
            e = e - jnp.where(inside, 4.0 * eps * (sc6 * sc6 - sc6), 0.0)
    return coef, e


def _kernel(*refs, names, spec: PackedSpec, block: int, with_energy: bool):
    n_in = len(names)
    r = dict(zip(names, refs[:n_in]))
    outs = refs[n_in:]
    C = spec.n_cells
    rc2 = float(spec.r_cut) ** 2
    k_eps, k_sig = pair_scales_for(spec)
    ueps, usig = spec.uniform_eps, spec.uniform_sigma

    b = pl.program_id(0)
    isl = pl.ds(b * block, block)
    ci = (b * block + jnp.arange(block, dtype=jnp.int32)) % C
    xi, yi, zi = r["x"][isl], r["y"][isl], r["z"][isl]
    se_i = r["se"][isl] if ueps is None else None
    hs_i = r["hs"][isl] if usig is None else None
    ty_i = r["ty"][isl] if spec.has_pair_table else None
    bp_i = ([r[f"bp{k}"][isl] for k in range(spec.bond_slots)]
            if spec.has_bonds else None)
    # 1 if the block holds an occupied slot, else 0 (arithmetic, not a
    # scalar select: the loop bound must stay i32 in the Triton IR)
    live = jnp.max((r["pid"][isl] < spec.n_real).astype(jnp.int32))

    def offset_body(o, acc):
        nb_idx = o * C + ci
        cell = r["nb"][nb_idx]
        sx, sy, sz = r["sx"][nb_idx], r["sy"][nb_idx], r["sz"][nb_idx]
        kmax = jnp.max(r["occ"][cell])

        def rank_body(k, acc):
            j = k * C + cell
            dx = xi - (r["x"][j] + sx)
            dy = yi - (r["y"][j] + sy)
            dz = zi - (r["z"][j] + sz)
            r2 = dx * dx + dy * dy + dz * dz
            eps = ueps if ueps is not None else se_i * r["se"][j]
            sig = usig if usig is not None else hs_i + r["hs"][j]
            if spec.has_pair_table:
                ty_j = r["ty"][j]
                if k_eps is not None:
                    eps = eps * k_eps(ty_i, ty_j)
                if k_sig is not None:
                    sig = sig * k_sig(ty_i, ty_j)
            coef, e = _pair_terms(r2, eps, sig, rc2, spec, with_energy,
                                  gate_eps=ueps is None)
            if spec.has_bonds:
                # bp attrs hold partner pid + 1; a bond is matched
                # regardless of r_cut, so a stretched bond keeps FENE+WCA
                pid1 = (r["pid"][j] + 1).astype(jnp.float32)
                match = bp_i[0] == pid1
                for bpk in bp_i[1:]:
                    match = match | (bpk == pid1)
                bonded = match & (r2 > 1e-12)
                e_b, coef_b = _fene_wca_pair(jnp.where(bonded, r2, 1.0),
                                             eps, sig, spec)
                coef = jnp.where(bonded, coef_b, coef)
                if with_energy:
                    e = jnp.where(bonded, e_b, e)
            fx, fy, fz = acc[0] + coef * dx, acc[1] + coef * dy, \
                acc[2] + coef * dz
            if not with_energy:
                return fx, fy, fz
            return (fx, fy, fz, acc[3] + e, acc[4] + coef * dx * dx,
                    acc[5] + coef * dy * dy, acc[6] + coef * dz * dz)

        return jax.lax.fori_loop(0, kmax, rank_body, acc)

    zero = jnp.zeros((block,), jnp.float32)
    acc0 = (zero,) * (7 if with_energy else 3)
    acc = jax.lax.fori_loop(0, 27 * live, offset_body, acc0)
    for ref, val in zip(outs, acc):
        ref[...] = val


def packed_lj_force_triton(state: PackedState, spec: PackedSpec,
                           with_energy: bool = True, cell_mask=None,
                           block: int = 64,
                           interpret: bool = False) -> PackedState:
    """Drop-in for :func:`ops.packed.packed_lj_force` (LJ pair kind).

    ``with_energy=False`` skips the energy and virial sums (inner MD
    steps; the state's scalars are left as they were).  ``cell_mask``
    ((C,) 0/1) restricts the energy/virial sums to i-slots in masked-in
    cells, as in the XLA path (the DD islands' ghost planes).

    ``block`` slots per program (a power of two) with NUM_WARPS warps:
    64 and 2 were the fastest of {64, 128, 256} × {2, 4, 8} at the
    62,500-particle flagship shape on an H100 (PERF.md, "Kernel
    decisions")."""
    assert spec.pair_kind == "lj", spec.pair_kind
    assert block & (block - 1) == 0, "Triton blocks are powers of two"
    cap, C = spec.cap, spec.n_cells
    npad = cap * C
    n_blk = -(-npad // block)
    pad = n_blk * block - npad

    def padded(a, fill):
        return jnp.pad(a, (0, pad), constant_values=fill) if pad else a

    # padded i-lanes read as vacant: sentinel coordinates, √ε = 0, and a
    # vacant pid; j indices never reach them (rank < cap)
    cfill = VACANT_X if spec.uniform_eps is not None else 0.0
    nb, ush = neighbor_cells(tuple(spec.cells_per_dim))
    shift = shift_rows_cart(ush, state.box)                  # (27, 3, C)
    valid = (state.pid < spec.n_real).reshape(cap, C)
    ranks = jnp.arange(1, cap + 1, dtype=jnp.int32)[:, None]
    occ = jnp.max(jnp.where(valid, ranks, 0), axis=0)        # (C,)

    ins = {"x": padded(state.r[0], cfill), "y": padded(state.r[1], cfill),
           "z": padded(state.r[2], cfill),
           "pid": padded(state.pid, spec.n_real)}
    if spec.uniform_eps is None:
        ins["se"] = padded(state.attrs["se"], 0.0)
    if spec.uniform_sigma is None:
        ins["hs"] = padded(state.attrs["hs"], 0.0)
    if spec.has_pair_table:
        ins["ty"] = padded(state.typ.astype(jnp.float32), 0.0)
    if spec.has_bonds:
        for k in range(spec.bond_slots):
            ins[f"bp{k}"] = padded(state.attrs[f"bp{k}"], 0.0)
    ins["nb"] = jnp.asarray(nb.reshape(-1))
    for d, name in enumerate(("sx", "sy", "sz")):
        ins[name] = shift[:, d, :].reshape(-1)
    ins["occ"] = occ
    names = tuple(ins)

    n_out = 7 if with_energy else 3
    # inside shard_map the outputs vary over the mesh axes the inputs do
    vma = frozenset().union(*(jax.typeof(a).vma for a in ins.values()))
    kern = functools.partial(_kernel, names=names, spec=spec, block=block,
                             with_energy=with_energy)
    out = pl.pallas_call(
        kern,
        grid=(n_blk,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * len(names),
        out_specs=[pl.BlockSpec((block,), lambda b: (b,))] * n_out,
        out_shape=[jax.ShapeDtypeStruct((n_blk * block,), jnp.float32,
                                        vma=vma)] * n_out,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="packed_lj_pair",
    )(*ins.values())
    out = [o[:npad] for o in out]
    state = state.replace(f=jnp.stack(out[:3]))
    if not with_energy:
        return state
    w = 1.0 if cell_mask is None else \
        jnp.broadcast_to(cell_mask[None, :], (cap, C)).reshape(-1)
    # every unordered pair was visited from both sides
    return state.replace(
        potential_energy=0.5 * jnp.sum(out[3] * w),
        virial=0.5 * jnp.stack([jnp.sum(o * w) for o in out[4:7]]))
