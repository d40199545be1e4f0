#!/usr/bin/env python
"""GPU smoke run of metadyn_tpu: the main path once, at full size.

    python chip_smoke.py               # one GPU: pair parity, headline, cli
    python chip_smoke.py --four-cards  # four GPUs: walkers and 1-D DD only

Phases (one process, one card unless ``--four-cards``):

1. ``pair_parity``: the chosen pair path (the Triton kernel on the GPU)
   against the XLA roll sweep and the particle-order all-pairs engine on
   three layouts at full width: the 62,500-particle flagship liquid
   (uniform σ/ε, coordinate sentinel), a Config-2-shaped FENE diblock melt
   with an ε table, and the flagship positions with a two-type ε table.
2. ``headline``: ``MetadSampler.run`` on the bench.py sampler (2 lamellar
   CVs, 64×64 well-tempered grid, stride 500, ``bias_every=5``) for 2 × 4
   strides; physics and run-health checks; particle-steps/s for
   information.
3. ``cli``: ``metadyn_tpu.cli.main(["run", cfg.json])`` in-process on
   Config 3 (Q6 + coordination, 62,500 particles), after checking both CV
   values at step 0 against plain references.

``--four-cards`` runs only what exists across cards: 4 walkers on 4 cards
through ``WalkerSampler`` (the shared grid equals the sum of every
walker's logged hills) and 1-D spatial DD over 4 cards against a
one-card ``PackedEngine``.

Each phase prints one JSON line; the first line names the card, the JAX
version, ``XLA_FLAGS`` and the compile-cache directory; the line before
the last is the card's name and power limit from nvidia-smi; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises: the exit
code is non-zero and the last line is not printed.  Without a GPU it
exits with code 2 before running anything.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / ".smoke"          # run outputs (listed in .gitignore)

# Config 3 (examples/config3_nucleation_2dcv.yaml), as JSON so the run
# needs no PyYAML; a few hundred steps, outputs under WORK, and an
# explicit coordination cutoff (1.5·r0) so its step-0 reference is
# defined independently of the cell stencil
CONFIG3 = {
    "seed": 3,
    "system": {"init": {"kind": "fcc", "n_cells": 25, "a": 1.6137}},
    "integrator": {"kind": "langevin", "dt": 0.004, "kT": 0.6,
                   "gamma": 1.0},
    "engine": {"kind": "packed", "skin": 0.4, "cap": 48,
               "uniform_sigma": 1.0, "uniform_eps": 1.0,
               "pair": {"kind": "lj", "r_cut": 2.5, "shift": False},
               "rebuild_every": 10},
    "cvs": [
        {"name": "q6", "kind": "steinhardt", "r_cut": 1.37, "l": 6,
         "grid": {"min": 0.0, "max": 0.7, "num_points": 48,
                  "sigma": 0.015}},
        {"name": "coord", "kind": "coordination", "r0": 1.54,
         "r_cut": 2.31,
         "grid": {"min": 12.0, "max": 36.0, "num_points": 48,
                  "sigma": 0.5}},
    ],
    "metadynamics": {"W": 0.4, "stride": 100, "mode": "well_tempered",
                     "deltaT": 6.0, "wall_k": 200.0, "bias_every": 10},
    "run": {"n_steps": 300, "report_every": 100},
}


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    """max |a − b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- phase 1: pair parity ---------------------------------------------------

# f32 sums in three different orders: per-slot in the kernel, per
# (cap_j, cap_i, C) block in the XLA sweep, per row block over all N in the
# all-pairs engine.  Forces: measured ~3e-7 of max |f| between kernel and
# sweep; 1e-4 leaves room for the all-pairs order and the cancellation in
# near-zero components.  Energy and virial are sums of ~10^6 terms of both
# signs, compared relative to their own magnitude.
TOL_F, TOL_E, TOL_W = 1e-4, 1e-4, 1e-4


def _compare(name, spec, state, ref_engine, ref_state, bonds=None):
    """Chosen pair path vs packed_lj_force vs the particle-order engine."""
    import jax
    import jax.numpy as jnp
    from metadyn_tpu.ops.packed import packed_lj_force
    from metadyn_tpu.ops.packed_triton import choose_pair_path, pair_force

    path = choose_pair_path(spec)
    out = jax.jit(lambda s: pair_force(s, spec, path))(state)
    with jax.default_matmul_precision("highest"):
        xla = jax.jit(lambda s: packed_lj_force(s, spec))(state)
        ref = jax.jit(ref_engine.force_into)(ref_state, None)
    f_ref, e_ref, w_ref = (np.asarray(ref.force),
                           float(ref.potential_energy),
                           np.asarray(ref.virial))
    if bonds is not None:
        f_ref, e_ref, w_ref = bonds(f_ref, e_ref, w_ref)
    slot_of = np.asarray(state.slot_of)
    f = np.asarray(out.f)[:, slot_of].T
    f_x = np.asarray(xla.f)[:, slot_of].T
    res = {
        "layout": name, "path": path, "n": int(spec.n_real),
        "f_vs_xla": rel_err(f, f_x), "f_vs_particle": rel_err(f, f_ref),
        "e_vs_xla": rel_err(out.potential_energy, xla.potential_energy),
        "e_vs_particle": rel_err(out.potential_energy, e_ref),
        "w_vs_particle": rel_err(out.virial, w_ref),
    }
    assert np.isfinite(f).all(), name
    assert max(res["f_vs_xla"], res["f_vs_particle"]) < TOL_F, res
    assert max(res["e_vs_xla"], res["e_vs_particle"]) < TOL_E, res
    assert res["w_vs_particle"] < TOL_W, res
    return res


def _flagship_liquid():
    import bench
    pos, vel, L = bench.load_liquid()
    return np.asarray(pos, np.float32), np.asarray(vel, np.float32), L


def _lattice_melt(chain_len=16, shape=(16, 16, 32), rho=0.85, seed=0):
    """Config-2-shaped diblock melt (8,192 beads, chains of 16, FENE
    bonds) on a simple-cubic lattice: chains run along z, bonds are one
    lattice spacing long, no overlaps."""
    a = (1.0 / rho) ** (1.0 / 3.0)
    nx, ny, nz = shape
    idx = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                               indexing="ij"), -1).reshape(-1, 3)
    Ls = a * np.asarray(shape, np.float64)
    pos = (idx + 0.5) * a - Ls / 2
    pos += np.random.default_rng(seed).normal(0, 0.05, pos.shape)
    n = pos.shape[0]
    k = np.arange(n)
    same_chain = (k % chain_len) != chain_len - 1
    bonds = np.stack([k[same_chain], k[same_chain] + 1], 1).astype(np.int32)
    types = ((k % chain_len) >= chain_len // 2).astype(np.int32)
    return pos.astype(np.float32), bonds, types, Ls.astype(np.float32)


def phase_pair_parity():
    import jax.numpy as jnp
    from bench import flagship_spec
    from metadyn_tpu.core.box import Box
    from metadyn_tpu.core.engine import AllPairsEngine
    from metadyn_tpu.core.state import make_state, make_system
    from metadyn_tpu.ops.bonds import FENEBondParams, fene_bond_force
    from metadyn_tpu.ops.packed import (
        PackedSpec, bond_partner_attrs, pack_host, pair_scale_tables,
        unpack_positions)
    from metadyn_tpu.ops.pairs import lj_kernel, lj_tables
    from metadyn_tpu.core.box import minimum_image

    results = []

    def particle_state(st, spec, box):
        return make_state(np.asarray(unpack_positions(st, spec)), box)

    # (a) flagship liquid: uniform σ = ε = 1, coordinate sentinel
    pos, _, L = _flagship_liquid()
    n = pos.shape[0]
    box = Box.cubic(L)
    spec = flagship_spec(L, n)
    st, ovf = pack_host(pos, box, spec, np.zeros(n, np.int32),
                        np.ones(n, np.float32), np.ones(n, np.float32))
    assert not ovf
    eng = AllPairsEngine(make_system(n), lj_tables(1, r_cut=2.5,
                                                   shift=False), lj_kernel)
    results.append(_compare("flagship", spec, st, eng,
                            particle_state(st, spec, box)))

    # (b) two-type ε table on the flagship positions
    eps_t = np.array([[1.0, 0.35], [0.35, 0.8]])
    types = np.random.default_rng(1).integers(0, 2, n).astype(np.int32)
    es, _, ed, _ = pair_scale_tables(eps_t)
    spec_t = PackedSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                               shift_energy=False, eps_scale=es)
    st_t, ovf = pack_host(pos, box, spec_t, types, ed[types],
                          np.ones(n, np.float32))
    assert not ovf
    eng_t = AllPairsEngine(make_system(n, types=types),
                           lj_tables(2, epsilon=eps_t, r_cut=2.5,
                                     shift=False), lj_kernel)
    results.append(_compare("eps_table", spec_t, st_t, eng_t,
                            particle_state(st_t, spec_t, box)))

    # (c) FENE diblock melt, Config-2 pair table (ε_AB = 0.6)
    pos_m, bonds, types_m, Ls = _lattice_melt()
    n_m = pos_m.shape[0]
    box_m = Box.from_lengths(*Ls)
    eps_m = np.array([[1.0, 0.6], [0.6, 1.0]])
    es, _, ed, _ = pair_scale_tables(eps_m)
    # cap 64: a cell of a perfect lattice holds up to 4 sites per axis
    spec_m = PackedSpec.create(Ls, n_m, r_cut=2.5, skin=0.4, cap=64,
                               eps_scale=es, fene_k=30.0, fene_r0=1.5)
    st_m, ovf = pack_host(pos_m, box_m, spec_m, types_m, ed[types_m],
                          np.ones(n_m, np.float32),
                          extra_attrs=bond_partner_attrs(bonds, n_m))
    assert not ovf
    params = lj_tables(2, epsilon=eps_m, r_cut=2.5, shift=True)
    sys_m = make_system(n_m, types=types_m, bonds=bonds)
    eng_m = AllPairsEngine(sys_m, params, lj_kernel)
    ps_m = particle_state(st_m, spec_m, box_m)
    # bonded pairs get FENE + WCA(ε_ij) instead of the pair LJ (HOOMD's
    # bond exclusion): swap the terms on the bond list
    i, j = bonds[:, 0], bonds[:, 1]
    p_m = jnp.asarray(ps_m.pos)
    dr = minimum_image(p_m[i] - p_m[j], box_m)
    r2 = jnp.sum(dr * dr, axis=-1)
    e_b, c_b = lj_kernel(r2, jnp.asarray(types_m[i]),
                         jnp.asarray(types_m[j]), params)
    f_b = (jnp.zeros((n_m, 3)).at[i].add(c_b[:, None] * dr)
           .at[j].add(-c_b[:, None] * dr))
    w_b = jnp.sum(c_b[:, None] * dr * dr, axis=0)
    junction = (types_m[i] != types_m[j]).astype(np.int32)
    fene = fene_bond_force(
        p_m, jnp.asarray(bonds), jnp.asarray(junction), box_m,
        FENEBondParams(k=jnp.asarray([30.0, 30.0]),
                       r0=jnp.asarray([1.5, 1.5]),
                       epsilon=jnp.asarray([1.0, 0.6]),
                       sigma=jnp.asarray([1.0, 1.0])))

    def swap_bonds(f, e, w):
        return (f - np.asarray(f_b) + np.asarray(fene.force),
                e - float(jnp.sum(e_b)) + float(fene.energy),
                w - np.asarray(w_b) + np.asarray(fene.virial))

    results.append(_compare("fene_melt", spec_m, st_m, eng_m, ps_m,
                            bonds=swap_bonds))
    return {"layouts": results,
            "tolerances": {"force": TOL_F, "energy": TOL_E,
                           "virial": TOL_W}}


# --- phase 2: headline ------------------------------------------------------

def phase_headline():
    import bench
    pos, vel, L = _flagship_liquid()
    sampler, stride, n = bench.build_sampler(pos, vel, L, bias_every=5,
                                             chunks_per_block=4)
    steps = 4 * stride
    t0 = time.perf_counter()
    h1 = sampler.run(steps)                  # compiles
    t_first = time.perf_counter() - t0
    hills1 = int(sampler.bias.n_hills)
    vmax1 = float(np.asarray(sampler.bias.grid.V).max())
    t0 = time.perf_counter()
    h2 = sampler.run(steps)
    dt = time.perf_counter() - t0
    hills2 = int(sampler.bias.n_hills)
    vmax2 = float(np.asarray(sampler.bias.grid.V).max())
    temps = [float(m["temperature"]) for m in h1 + h2]
    for m in h1 + h2:
        assert np.isfinite(m["potential_energy"]), m
        assert np.isfinite(m["cv"]).all(), m
        for flag in ("nlist_overflow", "nlist_stale",
                     "cell_width_violation"):
            assert not bool(m[flag]), (flag, m)
    assert hills2 > hills1 > 0, (hills1, hills2)
    assert vmax2 > vmax1 > 0.0, (vmax1, vmax2)
    assert all(0.9 <= t <= 1.1 for t in temps), temps
    return {"n": n, "pair_path": sampler.engine.pair_path,
            "steps_timed": steps, "first_run_s": t_first,
            "particle_steps_per_s": n * steps / dt, "hills": hills2,
            "bias_V_max": vmax2, "T_min": min(temps), "T_max": max(temps),
            "U": float(h2[-1]["potential_energy"])}


# --- phase 3: cli -----------------------------------------------------------

def _coordination_reference(pos, box, r0, r_cut):
    """Σ over the cell-list neighbour pairs of the stretched switching
    function 1/(1+(r/r0)^6), per particle (both orderings counted)."""
    import jax
    import jax.numpy as jnp
    from metadyn_tpu.core.box import minimum_image
    from metadyn_tpu.ops.cell_list import CellSpec, build_neighbor_list

    n = pos.shape[0]
    cspec = CellSpec.create(np.asarray(box.L), n, r_cut=r_cut, skin=0.0)
    p = jnp.asarray(pos)
    nbr = jax.jit(build_neighbor_list, static_argnums=2)(p, box, cspec)
    assert not bool(nbr.overflow)
    idx = nbr.idx
    valid = idx < n
    d = minimum_image(p[:, None, :] - p[jnp.minimum(idx, n - 1)], box)
    r2 = jnp.sum(d * d, -1)
    sw = 1.0 / (1.0 + (r2 / r0 ** 2) ** 3)
    sc = 1.0 / (1.0 + (r_cut / r0) ** 6)
    s = jnp.where(valid & (r2 < r_cut ** 2), (sw - sc) / (1.0 - sc), 0.0)
    return float(jnp.sum(s.astype(jnp.float32)) / n)


def phase_cli():
    import jax
    from metadyn_tpu import cli
    from metadyn_tpu.core.state import make_state
    from metadyn_tpu.cv.steinhardt import SteinhardtQl
    from metadyn_tpu.ops.packed import unpack_positions

    WORK.mkdir(exist_ok=True)
    cfg = json.loads(json.dumps(CONFIG3))
    cfg["output"] = {"hill_file": str(WORK / "config3_hills.txt"),
                     "grid_file": str(WORK / "config3_grid.npz"),
                     "overwrite": True}
    path = WORK / "config3.json"
    path.write_text(json.dumps(cfg, indent=1))

    # step-0 CV values against plain references
    sampler, _ = cli.build_sampler(cli.load_config(str(path)))
    st, spec = sampler.state, sampler.engine.spec
    q6, coord = sampler.cvs
    s0 = [float(cv.value(st, sampler.system)) for cv in (q6, coord)]
    pos = np.asarray(unpack_positions(st, spec))
    box = st.box
    q6_ref = float(jax.jit(SteinhardtQl(r_cut=q6.r_cut, l=6).value)(
        make_state(pos, box), sampler.system))
    co_ref = _coordination_reference(pos, box, coord.r0, coord.r_cut)
    # f32 sums over ~10^6 bonds in different orders
    assert rel_err(s0[0], q6_ref) < 1e-4, (s0[0], q6_ref)
    assert rel_err(s0[1], co_ref) < 1e-4, (s0[1], co_ref)
    del sampler

    t0 = time.perf_counter()
    rc = cli.main(["run", str(path)])
    assert rc == 0, rc
    rows = [r for r in open(cfg["output"]["hill_file"])
            if not r.startswith("#")]
    assert len(rows) == cfg["run"]["n_steps"] // 100, rows
    return {"q6_step0": s0[0], "q6_ref": q6_ref, "coord_step0": s0[1],
            "coord_ref": co_ref, "run_s": time.perf_counter() - t0,
            "hills": len(rows), "steps": cfg["run"]["n_steps"]}


# --- --four-cards phases ----------------------------------------------------

def _distinct_devices(x, k, axis):
    """Assert ``x`` is split along ``axis`` into k shards, one per card."""
    assert not x.sharding.is_fully_replicated, x.sharding
    shards = x.addressable_shards
    devs = {s.device for s in shards}
    assert len(devs) == k, devs
    assert all(s.data.shape[axis] * k == x.shape[axis] for s in shards), \
        [s.data.shape for s in shards]
    return sorted(str(d) for d in devs)


def phase_walkers(n_walkers=4, strides=4):
    """4 walkers (flagship liquid each) on 4 cards; the shared grid must
    equal the sum of every walker's logged hills."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    import bench
    from metadyn_tpu.core.box import Box
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WallSpec, WELL_TEMPERED
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.io.hill_log import read_hills
    from metadyn_tpu.parallel.walkers import WalkerSampler

    pos, vel, L = _flagship_liquid()
    n = pos.shape[0]
    box = Box.cubic(L)
    spec = bench.flagship_spec(L, n)
    engine = PackedEngine(spec, rebuild_every=10)
    cv1 = PackedLamellar.create([[0, 0, 3]], n_real=n, name="a")
    cv2 = PackedLamellar.create([[0, 3, 0]], n_real=n, name="b")
    amps = np.ones(n, np.float32)
    states = []
    for w in range(n_walkers):
        v = np.random.default_rng(10 + w).normal(0, 1.0, vel.shape)
        v = (v - v.mean(0)).astype(np.float32)
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), np.ones(n, np.float32),
            np.ones(n, np.float32), vel=v,
            extra_attrs={cv1.attr_name: amps, cv2.attr_name: amps})
        assert not ovf
        states.append(st)
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    gspec = GridSpec.create([-0.06, -0.06], [0.06, 0.06], [64, 64],
                            [0.004, 0.004])
    WORK.mkdir(exist_ok=True)
    hill_file = WORK / "walkers_hills.txt"
    stride = 500
    mesh = Mesh(np.asarray(jax.devices()[:n_walkers]), ("walkers",))
    sampler = WalkerSampler(
        make_system(n), states, engine, cvs=[cv1, cv2], grid_spec=gspec,
        hills=HillSpec.create(W=0.1, stride=stride, mode=WELL_TEMPERED,
                              deltaT=5.0),
        integrator_factory=lambda f: make_packed_langevin_step(
            f, dt=0.005, kT=1.0, gamma=1.0),
        mesh=mesh, seed=0, walls=WallSpec.at_grid_edges(gspec, k=2000.0),
        hill_file=str(hill_file), overwrite=True, chunks_per_block=strides,
        bias_every=5)
    t0 = time.perf_counter()
    hist = sampler.run(strides * stride)
    run_s = time.perf_counter() - t0
    m = hist[-1]
    assert np.isfinite(np.asarray(m["cv"])).all()
    assert not np.any(np.asarray(m["nlist_overflow"]))
    devices = _distinct_devices(sampler.states.r, n_walkers, 0)

    h = read_hills(str(hill_file))
    assert h["center"].shape[0] == n_walkers * strides, h["center"].shape
    grids = np.meshgrid(*[np.asarray(gspec.axis_coords(d), np.float64)
                          for d in range(2)], indexing="ij")
    v_ref = np.zeros(gspec.shape)
    for c, s, w in zip(h["center"], h["sigma"], h["height"]):
        v_ref += w * np.exp(-sum((g - cd) ** 2 / (2 * sd * sd)
                                 for g, cd, sd in zip(grids, c, s)))
    V = np.asarray(sampler.bias.grid.V)
    err = rel_err(V, v_ref)
    # f32 grid accumulation vs an f64 sum of heights logged to 8 digits
    assert err < 1e-4, err
    return {"walkers": n_walkers, "devices": devices, "hills": int(
        sampler.bias.n_hills), "grid_vs_logged_hills": err,
        "run_s": run_s}


def phase_dd(n_dev=4, n_cells=28, steps=200):
    """1-D spatial DD over 4 cards vs one card, always_repack, 200 steps:
    87,808 particles (fcc, ρ 0.8, 16 x-cells: 4 per card)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from metadyn_tpu.core.box import Box
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.ops.packed import PackedSpec, unpack_positions
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.utils.lattice import fcc_lattice

    a = (4.0 / 0.8) ** (1.0 / 3.0)
    pos = fcc_lattice(n_cells, a)
    n = pos.shape[0]
    L = n_cells * a
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=48,
                             shift_energy=False)
    assert spec.cells_per_dim[0] % n_dev == 0, spec.cells_per_dim
    vel = np.random.default_rng(0).normal(0, 1.0, (n, 3)).astype(np.float32)
    vel -= vel.mean(0)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("space",))

    def run(engine):
        st, ovf = engine.pack_state(pos, box, np.zeros(n, np.int32),
                                    np.ones(n, np.float32),
                                    np.ones(n, np.float32), vel=vel)
        assert not ovf
        step = make_packed_langevin_step(
            lambda s: engine.force_into(s, None), dt=0.005, kT=1.0)

        @jax.jit
        def go(st):
            st, aux = engine.init(st)

            def blk(c, b):
                s2, a2 = engine.rebuild(*c)

                def body(s, i):
                    return step(s, jax.random.fold_in(
                        jax.random.PRNGKey(7), b * 10 + i)), None
                return (jax.lax.scan(body, s2, jnp.arange(10))[0], a2), None
            return jax.lax.scan(blk, (st, aux), jnp.arange(steps // 10))[0]

        t0 = time.perf_counter()
        st, aux = go(st)
        jax.block_until_ready(st.r)
        assert not bool(aux.overflow)
        return st, time.perf_counter() - t0

    st1, t1 = run(PackedEngine(spec, rebuild_every=10, always_repack=True))
    dd = SpatialPackedEngine(spec, mesh, rebuild_every=10,
                             always_repack=True)
    st4, t4 = run(dd)
    # the force island's output, in its own (3, cap, C) layout: each card
    # holds the interior x-slab of its cells
    f = jax.jit(lambda s: dd.force_into(s, None).f.reshape(
        3, spec.cap, spec.n_cells))(st4)
    devices = _distinct_devices(f, n_dev, 2)
    p1 = np.asarray(unpack_positions(st1, spec), np.float64)
    p4 = np.asarray(unpack_positions(st4, spec), np.float64)
    d = p4 - p1
    d -= L * np.round(d / L)
    err = float(np.abs(d).max())
    # same slot order and per-slot summation order on both engines (the
    # sharded repack is bit-identical); what differs is f32 rounding in
    # the halo-extended local grids, amplified by 200 chaotic steps
    assert err < 1e-3, err
    return {"n": n, "devices": devices, "pair_path": dd.pair_path,
            "steps": steps, "max_abs_dr": err, "one_card_s": t1,
            "four_card_s": t4}


# --- driver -----------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card phases (walkers, DD)")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend: {jax.default_backend()})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from metadyn_tpu.utils.cache import enable_persistent_cache
    cache = enable_persistent_cache()
    card = card_line()
    print(json.dumps({"card": card, "jax": jax.__version__,
                      "xla_flags": os.environ.get("XLA_FLAGS", ""),
                      "cache_dir": cache}), flush=True)

    n_cards = 4 if args.four_cards else 1
    assert len(jax.devices()) >= n_cards, jax.devices()
    phases = ([("walkers", phase_walkers), ("dd_1d", phase_dd)]
              if args.four_cards else
              [("pair_parity", phase_pair_parity),
               ("headline", phase_headline), ("cli", phase_cli)])
    for name, fn in phases:
        t0 = time.perf_counter()
        nums = fn()
        print(json.dumps({"phase": name, "ok": True,
                          "seconds": time.perf_counter() - t0, **nums}),
              flush=True)

    dev = jax.devices()[0]
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
