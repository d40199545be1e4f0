"""Command-line driver: ``metadyn run config.yaml [--resume]``.

Reference parity: the reference's "config" is python-constructor kwargs
plus HOOMD CLI flags (SURVEY.md §5 config/flag system); here a typed YAML
config drives the same parameter names.  ``examples/`` contains YAML
configs for the full baseline set (BASELINE.md Configs 1–5), including
multi-walker (``mode: walkers``), flux-tempered (``mode: flux_tempered``),
NVT/NPT integrator selection, periodic checkpointing with ``--resume``,
and trajectory output.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _assign_order(c: dict) -> int:
    """Mesh-CV particle→mesh window from YAML: ``assign: cic`` (default,
    order 2) or ``assign: tsc`` (order 3) — SURVEY.md §3.3 "CIC/TSC"."""
    name = str(c.get("assign", "cic")).lower()
    try:
        return {"cic": 2, "tsc": 3}[name]
    except KeyError:
        raise ValueError(f"cvs.assign must be cic or tsc, got {name!r}")


def _build_particle_cvs(cvs_cfg, system, L, pos):
    from .cv.lamellar import LamellarOP
    from .cv.mesh import MeshOrderParameter
    from .cv.steinhardt import SteinhardtQl
    from .cv.msd import MSD
    from .cv.aspect_ratio import AspectRatio
    from .cv.simple import PotentialEnergyCV

    cvs = []
    for c in cvs_cfg:
        kind = c["kind"]
        if kind == "lamellar":
            cvs.append(LamellarOP.create(
                mode=c.get("mode", [1.0] * system.n_types),
                lattice_vectors=[c["lattice_vector"]], name=c["name"]))
        elif kind == "mesh":
            cvs.append(MeshOrderParameter.create(
                tuple(c["mesh"]), L, mode=c.get("mode", [1.0] * system.n_types),
                k0=c["k0"], width=c.get("width", 0.5), name=c["name"],
                assign_order=_assign_order(c)))
        elif kind == "steinhardt":
            cvs.append(SteinhardtQl(r_cut=c["r_cut"], l=c.get("l", 6),
                                    name=c["name"]))
        elif kind == "msd":
            cvs.append(MSD.create(pos, name=c["name"]))
        elif kind == "aspect_ratio":
            cvs.append(AspectRatio(axis_a=int(c.get("axis_a", 0)),
                                   axis_b=int(c.get("axis_b", 1)),
                                   name=c["name"]))
        elif kind == "wte":
            cvs.append(PotentialEnergyCV(name=c["name"]))
        else:
            raise ValueError(f"unknown cv kind {kind}")
    if any(c["kind"] == "wte" for c in cvs_cfg):
        assert all(hasattr(cv, "accum_bias_force") or c["kind"] == "wte"
                   for cv, c in zip(cvs, cvs_cfg)), (
            "wte (energy CV) needs every co-registered CV to provide an "
            "analytic bias force — combine it with packed CVs or use it "
            "alone")
    return cvs


def _build_packed_cvs(cvs_cfg, spec, n, types, pos, system,
                      smesh=None, box_L=None, smesh2d=None,
                      nested=False):
    """Packed CV zoo: lamellar, mesh, steinhardt/q6, coordination, msd.

    With ``smesh`` (a ``"space"``-axis device mesh from
    ``engine.spatial_devices``), the mesh CV becomes the distributed
    slab-FFT ``ShardedPackedMesh``; with ``smesh2d`` (a
    ``("spacex", "spacey")`` mesh from a 2-element ``spatial_devices``)
    it becomes the pencil-FFT ``ShardedPackedMesh2D``.  lamellar/msd and
    the roll-sweep order CVs are GSPMD-sharded by XLA unchanged.
    ``nested=True`` (walkers x space product meshes) builds the FFT
    islands for use inside the walker-manual region.
    """
    from .cv.packed import PackedLamellar, PackedMesh, PackedMSD, \
        msd_reference_attrs
    from .cv.packed_order import PackedSteinhardtQl, PackedCoordination

    cvs, extra_attrs = [], {}
    for c in cvs_cfg:
        kind = c["kind"]
        if kind == "lamellar":
            cv = PackedLamellar.create([c["lattice_vector"]], n_real=n,
                                       name=c["name"])
            extra_attrs[cv.attr_name] = np.asarray(
                c.get("mode", [1.0] * system.n_types), np.float32)[types]
        elif kind == "mesh":
            if smesh is not None:
                from .parallel.mesh import ShardedPackedMesh
                cv = ShardedPackedMesh.create(
                    tuple(c["mesh"]), spec, smesh, n_real=n, k0=c["k0"],
                    width=c.get("width", 0.5), box_L=box_L, name=c["name"],
                    assign_order=_assign_order(c), nested=nested)
            elif smesh2d is not None:
                from .parallel.mesh2d import ShardedPackedMesh2D
                cv = ShardedPackedMesh2D.create(
                    tuple(c["mesh"]), spec, smesh2d, n_real=n, k0=c["k0"],
                    width=c.get("width", 0.5), box_L=box_L, name=c["name"],
                    assign_order=_assign_order(c), nested=nested)
            else:
                cv = PackedMesh.create(tuple(c["mesh"]), None, n_real=n,
                                       k0=c["k0"], width=c.get("width", 0.5),
                                       name=c["name"],
                                       assign_order=_assign_order(c))
            extra_attrs[cv.attr_name] = np.asarray(
                c.get("mode", [1.0] * system.n_types), np.float32)[types]
        elif kind in ("steinhardt", "q6"):
            # works under engine.spatial_devices too: the packed order
            # CVs are pure roll-sweep jnp on the sharded engine, so GSPMD
            # turns their cross-shard rolls into collectives (differential-
            # tested in tests/test_spatial.py::test_order_cvs_under_spatial_dd)
            cv = PackedSteinhardtQl(spec=spec, r_cut=float(c["r_cut"]),
                                    l=int(c.get("l", 6)), name=c["name"])
        elif kind == "coordination":
            cv = PackedCoordination(spec=spec, r0=float(c["r0"]),
                                    r_cut=(float(c["r_cut"])
                                           if "r_cut" in c else None),
                                    name=c["name"])
        elif kind == "msd":
            cv = PackedMSD(n_real=n, name=c["name"])
            extra_attrs.update(msd_reference_attrs(pos))
        elif kind == "wte":
            from .cv.simple import PotentialEnergyCV
            cv = PotentialEnergyCV(name=c["name"])
        elif kind == "aspect_ratio":
            # box-shape metadynamics on the packed engine: the CV reads
            # only box.L (exact under spatial DD — the box is replicated
            # and the DD force psums the per-axis virial); pair it with
            # integrator {kind: npt_scr, box_bias: true, anisotropic:
            # true} so ∂V/∂s couples to the box DOF inside the chunk
            from .cv.aspect_ratio import AspectRatio
            cv = AspectRatio(axis_a=int(c.get("axis_a", 0)),
                             axis_b=int(c.get("axis_b", 1)),
                             name=c["name"])
        else:
            raise ValueError(f"unknown packed cv kind {kind}")
        cvs.append(cv)
    return cvs, extra_attrs


def _grid_from_cfg(cvs_cfg, mcfg):
    from .bias.grid import GridSpec

    if not all("grid" in c for c in cvs_cfg):
        return None   # hill-list (non-grid) mode
    return GridSpec.create(
        [c["grid"]["min"] for c in cvs_cfg],
        [c["grid"]["max"] for c in cvs_cfg],
        [c["grid"]["num_points"] for c in cvs_cfg],
        [c["grid"]["sigma"] for c in cvs_cfg],
        periodic=[bool(c["grid"].get("periodic", False)) for c in cvs_cfg])


def _integrator_factory(icfg, system, packed: bool, spec=None,
                        engine=None):
    from .integrate.langevin import make_langevin_step
    from .integrate.nvt import make_nvt_nh_step, make_nvt_bdp_step
    from .integrate.npt import make_npt_scr_step
    from .integrate.packed import make_packed_langevin_step, \
        make_packed_nve_step, make_packed_npt_scr_step

    kind = icfg.get("kind", "langevin")
    dt = float(icfg["dt"])
    kT = float(icfg.get("kT", 1.0))
    if packed:
        if kind == "langevin":
            return lambda f: make_packed_langevin_step(
                f, dt=dt, kT=kT, gamma=float(icfg.get("gamma", 1.0)))
        if kind == "nve":
            return lambda f: make_packed_nve_step(f, dt=dt)
        if kind == "npt_scr":
            kw = dict(dt=dt, kT=kT, pressure=float(icfg["pressure"]),
                      gamma=float(icfg.get("gamma", 1.0)),
                      tau_p=float(icfg.get("tau_p", 2.0)),
                      anisotropic=bool(icfg.get("anisotropic", False)),
                      kappa=float(icfg.get("kappa", 0.1)))
            if bool(icfg.get("box_bias", False)):
                from .cv.aspect_ratio import AspectRatio, box_bias_fn_for

                def factory(f, bias, _kw=kw):
                    cv = AspectRatio()
                    return make_packed_npt_scr_step(
                        f, spec, box_bias_fn=box_bias_fn_for(cv, bias),
                        engine=engine, **_kw)
                return factory
            return lambda f: make_packed_npt_scr_step(f, spec,
                                                      engine=engine, **kw)
        raise ValueError(
            f"packed engine supports langevin/nve/npt_scr, got {kind}")
    if kind == "langevin":
        return lambda f: make_langevin_step(
            f, system, dt=dt, kT=kT, gamma=float(icfg.get("gamma", 1.0)))
    if kind == "nvt_nh":
        return lambda f: make_nvt_nh_step(
            f, system, dt=dt, kT=kT, tau=float(icfg.get("tau", 0.5)))
    if kind == "nvt_bdp":
        return lambda f: make_nvt_bdp_step(
            f, system, dt=dt, kT=kT, tau=float(icfg.get("tau", 0.5)))
    if kind == "npt_scr":
        kw = dict(dt=dt, kT=kT, pressure=float(icfg["pressure"]),
                  gamma=float(icfg.get("gamma", 1.0)),
                  tau_p=float(icfg.get("tau_p", 2.0)),
                  anisotropic=bool(icfg.get("anisotropic", False)),
                  kappa=float(icfg.get("kappa", 0.1)))
        if bool(icfg.get("box_bias", False)):
            # box-shape metadynamics: couple the bias to the box DOF
            from .cv.aspect_ratio import AspectRatio, box_bias_fn_for

            def factory(f, bias, _kw=kw):
                cv = AspectRatio()
                return make_npt_scr_step(
                    f, system, box_bias_fn=box_bias_fn_for(cv, bias), **_kw)
            return factory
        return lambda f: make_npt_scr_step(f, system, **kw)
    raise ValueError(f"unknown integrator kind {kind}")


_REMOVED_KEYS = {
    ("metadynamics", "mts_lag"):
        "the lagged fused-MTS mode was removed; use bias_every for "
        "multiple-time-stepping of the bias force",
    ("engine", "pair_pallas"):
        "the pair force is chosen by platform (the Triton kernel on the "
        "GPU, the XLA roll sweep elsewhere)",
    ("engine", "order_pallas"):
        "the order CVs run on the XLA roll sweep on every platform",
}


def build_sampler(cfg: dict, resume: bool = False):
    import jax
    import jax.numpy as jnp
    from .core.box import Box
    from .core.state import make_state, make_system
    from .core.engine import AllPairsEngine
    from .core.packed_engine import PackedEngine
    from .ops.packed import PackedSpec, bond_partner_attrs
    from .ops import pairs as pair_mod
    from .bias.metad import HillSpec, WallSpec
    from .sampler import MetadSampler
    from .flux_sampler import FluxTemperedSampler
    from .parallel.walkers import WalkerSampler
    from .utils import lattice

    for (section, key), why in _REMOVED_KEYS.items():
        if key in cfg.get(section, {}):
            raise ValueError(f"{section}.{key} is no longer supported: {why}")
    sys_cfg = cfg["system"]
    icfg = cfg["integrator"]
    kT = float(icfg.get("kT", 1.0))
    out_cfg = cfg.get("output", {})

    # --- initial configuration -------------------------------------------
    init = sys_cfg["init"]
    kind = init["kind"]
    if kind == "fcc":
        pos = lattice.fcc_lattice(init["n_cells"], init["a"])
        L = init["n_cells"] * init["a"]
        bonds = None
    elif kind == "sc":
        pos = lattice.sc_lattice(init["n_per_side"], init["spacing"])
        L = init["n_per_side"] * init["spacing"]
        bonds = None
    elif kind == "melt":
        L = init["box_L"]
        pos, bonds = lattice.polymer_melt(
            init["n_chains"], init["chain_len"], L,
            seed=init.get("seed", 0))
        prerelax = int(init.get("prerelax_steps", 0))
        if prerelax:
            # push off the random-walk overlaps with the soft potential
            # before the production pair potential (required — WCA+FENE on
            # an overlapping melt blows up)
            from .core.state import make_state as _mk
            from .core.forcefield import ForceField
            from .ops.bonds import FENEBondParams
            from .ops.pairs import soft_tables, soft_kernel
            from .integrate.langevin import make_langevin_step as _mls
            from .integrate.base import run_steps as _rs
            n0 = pos.shape[0]
            # push-off is type-blind (single soft table)
            sys0 = make_system(n0, bonds=bonds)
            fene0 = cfg["engine"].get("fene", {"k": 30.0, "r0": 1.5})
            ff0 = ForceField(
                pair_params=soft_tables(1, A=100.0, r_cut=1.0),
                pair_kernel=soft_kernel, row_block=min(n0, 1024),
                fene=FENEBondParams(
                    k=jnp.full(1, float(fene0["k"])),
                    r0=jnp.full(1, float(fene0["r0"])),
                    epsilon=jnp.ones(1), sigma=jnp.ones(1)))
            fa0 = ff0.bind(sys0)
            st0 = fa0(_mk(pos, Box.cubic(float(L))))
            step0 = _mls(fa0, sys0, dt=0.002, kT=kT, gamma=2.0)
            st0 = jax.jit(lambda s: _rs(step0, s, jax.random.PRNGKey(
                int(init.get("seed", 0)) + 99), prerelax))(st0)
            pos = np.asarray(st0.unwrapped_pos())
    else:
        raise ValueError(f"unknown init kind {kind}")
    n = pos.shape[0]
    tilt = sys_cfg.get("tilt")
    if tilt is not None:
        # triclinic runs on the all-pairs engine, the packed cell engine
        # (fractional binning; ops/packed.py), and — round 5 — the 1-D
        # spatial decomposition (the slab axis is fractional x, whose
        # lattice vector a1 = (Lx, 0, 0) keeps the seam shift
        # orthorhombic-shaped; parallel/spatial.py).  The 2-D mesh and
        # the distributed FFT mesh CV keep orthorhombic guards (their
        # y-seam shift / Cartesian mesh fractions would need a2-aware
        # halos).
        assert cfg["engine"]["kind"] in ("all_pairs", "packed"), (
            "system.tilt requires engine.kind: all_pairs or packed")
        sp_chk = cfg["engine"].get("spatial_devices", 1) or 1
        assert not isinstance(sp_chk, (list, tuple)), (
            "system.tilt is not supported with the 2-D decomposition "
            "(spatial_devices: [nx, ny]); use 1-D slabs")
        if int(sp_chk) > 1:
            assert not any(c["kind"] == "mesh"
                           for c in cfg.get("cvs", [])), (
                "system.tilt + spatial_devices: the distributed FFT mesh "
                "CV is orthorhombic-only; use lamellar/order CVs under "
                "tilted DD")
        xy, xz, yz = (float(t) for t in tilt)
        box = Box.triclinic(float(L), float(L), float(L), xy, xz, yz)
    else:
        box = Box.cubic(float(L))
    tcfg = sys_cfg.get("types", None)
    if tcfg == "diblock":
        # diblock copolymer: first half of each chain type 0 (A), second
        # half type 1 (B) — pair with cv mode [1, -1] for the A-B contrast
        cl = int(init["chain_len"])
        t = np.zeros((n // cl, cl), np.int32)
        t[:, cl // 2:] = 1
        types = t.reshape(-1)
    else:
        types = np.asarray(tcfg if tcfg is not None else np.zeros(n),
                           np.int32)
    system = make_system(n, types=types, bonds=bonds)

    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    vel = rng.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)

    # --- engine ----------------------------------------------------------
    eng_cfg = cfg["engine"]
    pair = eng_cfg.get("pair", {"kind": "lj", "r_cut": 2.5})
    cvs_cfg = cfg.get("cvs", [])
    mcfg = cfg["metadynamics"]
    mode = mcfg.get("mode", "standard")
    n_walkers = int(mcfg.get("n_walkers", 1))
    wmesh = None          # walkers x space product mesh (set below)

    if eng_cfg["kind"] == "packed":
        r_cut = float(pair.get("r_cut", 2.0 ** (1 / 6)
                               if pair["kind"] == "wca" else 2.5))
        # bonds: engine.bonds {kind: fene|harmonic, k, r0}; engine.fene
        # remains the legacy spelling (kind defaults to fene)
        fene = eng_cfg.get("bonds", eng_cfg.get("fene"))
        # per-type-PAIR coefficient tables (HOOMD PotentialPair parity):
        # engine.pair.eps_table / sigma_table are (n_types, n_types)
        # nested lists — e.g. eps_table [[1.0, 0.6], [0.6, 1.0]] gives a
        # demixing diblock (eps_AB < sqrt(eps_A*eps_B), chi > 0)
        eps_tab = pair.get("eps_table")
        sig_tab = pair.get("sigma_table")
        eps_i = np.ones(n, np.float32)
        sigma_i = np.ones(n, np.float32)
        eps_scale = sigma_scale = None
        if eps_tab is not None:
            from .ops.packed import pair_scale_tables
            eps_scale, sigma_scale, ed, sd = pair_scale_tables(
                eps_tab, sig_tab)
            eps_i = ed[types]
            if sd is not None:
                sigma_i = sd[types]
        else:
            assert sig_tab is None, "sigma_table requires eps_table"
        spec = PackedSpec.create(
            L, n, r_cut=r_cut,
            skin=float(eng_cfg.get("skin", 0.4)),
            cap=eng_cfg.get("cap"),
            shift_energy=bool(pair.get("shift", pair["kind"] == "wca")),
            fene_k=None if fene is None else float(fene["k"]),
            fene_r0=None if fene is None else float(fene["r0"]),
            bond_kind=(fene or {}).get("kind", "fene"),
            uniform_sigma=eng_cfg.get("uniform_sigma"),
            uniform_eps=eng_cfg.get("uniform_eps"),
            pair_kind="soft" if pair["kind"] == "soft" else "lj",
            eps_scale=eps_scale, sigma_scale=sigma_scale,
            tilt=tilt)
        # spatial domain decomposition: engine.spatial_devices shards the
        # cell grid over the first N devices (the mpirun/-nrank analog —
        # one YAML key instead of a launcher flag).  A [nx, ny] list
        # selects the 2-D decomposition (parallel/spatial2d): x AND y
        # cell axes sharded — for device counts beyond cx or when the
        # slab ghost fraction dominates.
        sp_raw = eng_cfg.get("spatial_devices", 1) or 1
        sp_dev = 1 if isinstance(sp_raw, (list, tuple)) else int(sp_raw)
        smesh = None
        smesh2d = None
        # npt_scr reads state.virial and wte state.potential_energy every
        # step — the engines must keep EVERY force call on a live
        # energy/virial path (with_energy)
        want_energy = (icfg.get("kind") == "npt_scr"
                       or any(c["kind"] == "wte" for c in cvs_cfg)
                       or bool(eng_cfg.get("with_energy", False)))
        if isinstance(sp_raw, (list, tuple)):
            nx, ny = int(sp_raw[0]), int(sp_raw[1])
            from jax.sharding import Mesh as _JaxMesh
            from .parallel.spatial2d import SpatialPackedEngine2D
            devs = jax.devices()
            if n_walkers > 1:
                # walkers x 2-D space: the reference's
                # ``mpirun -n W*nx*ny --nrank W`` with 2-D sub-boxes —
                # walker partitions, each internally (x, y)-decomposed
                need = n_walkers * nx * ny
                if len(devs) < need:
                    raise ValueError(
                        f"{n_walkers} walkers x {sp_raw} spatial shards "
                        f"need {need} devices, have {len(devs)}")
                wmesh = _JaxMesh(
                    np.asarray(devs[:need]).reshape(n_walkers, nx, ny),
                    ("walkers", "spacex", "spacey"))
                smesh2d = wmesh
                engine = SpatialPackedEngine2D(
                    spec, wmesh, nested=True,
                    rebuild_every=int(eng_cfg.get("rebuild_every", 1)),
                    with_energy=want_energy)
            else:
                need = nx * ny
                if len(devs) < need:
                    raise ValueError(
                        f"engine.spatial_devices={sp_raw} needs {need} "
                        f"devices, have {len(devs)}")
                m2d = _JaxMesh(np.asarray(devs[:need]).reshape(nx, ny),
                               ("spacex", "spacey"))
                smesh2d = m2d
                engine = SpatialPackedEngine2D(
                    spec, m2d,
                    rebuild_every=int(eng_cfg.get("rebuild_every", 1)),
                    with_energy=want_energy)
            bad = {c["kind"] for c in cvs_cfg} - {
                "lamellar", "msd", "steinhardt", "q6", "coordination",
                "wte", "mesh"}
            if bad:
                raise ValueError(
                    f"cv kinds {sorted(bad)} are not supported under the "
                    "2-D decomposition yet")
        elif sp_dev > 1:
            from jax.sharding import Mesh as _JaxMesh
            from .parallel.spatial import SpatialPackedEngine
            devs = jax.devices()
            if len(devs) < sp_dev:
                raise ValueError(
                    f"engine.spatial_devices={sp_dev} but only "
                    f"{len(devs)} devices are visible")
            if n_walkers > 1:
                # product mesh: n_walkers partitions, each domain-
                # decomposed over spatial_devices shards — the reference's
                # ``mpirun -n W*S --nrank W``.  The walker chunk goes
                # manual over "walkers"; the engine's nested halo islands
                # manualize "space" (parallel/spatial.py).  lamellar/msd
                # reductions and the roll-sweep order CVs run inside the
                # walkers-manual region with "space" left to GSPMD; the
                # mesh CV nests its slab-FFT island under the walker axis
                # (ShardedPackedMesh(nested=True)); with_energy covers
                # npt_scr/wte (the nested XLA force path psums
                # interior-masked energy + per-axis virial per call).
                need = n_walkers * sp_dev
                if len(devs) < need:
                    raise ValueError(
                        f"{n_walkers} walkers x {sp_dev} spatial shards "
                        f"need {need} devices, have {len(devs)}")
                wmesh = _JaxMesh(
                    np.asarray(devs[:need]).reshape(n_walkers, sp_dev),
                    ("walkers", "space"))
                smesh = wmesh
                engine = SpatialPackedEngine(
                    spec, wmesh, nested=True,
                    rebuild_every=int(eng_cfg.get("rebuild_every", 1)),
                    with_energy=want_energy)
            else:
                smesh = _JaxMesh(np.asarray(devs[:sp_dev]), ("space",))
                engine = SpatialPackedEngine(
                    spec, smesh,
                    rebuild_every=int(eng_cfg.get("rebuild_every", 1)),
                    with_energy=want_energy)
        else:
            engine = PackedEngine(
                spec, rebuild_every=int(eng_cfg.get("rebuild_every", 1)),
                with_energy=want_energy)
        if getattr(engine, "_nested_islands", False):
            kinds = {c["kind"] for c in cvs_cfg}
            if "aspect_ratio" in kinds:
                raise ValueError(
                    "the aspect-ratio (box-shape) CV needs the two-arg "
                    "box-coupled integrator factory, which multi-walker "
                    "chunks do not support — not available on a walkers "
                    "x space product mesh (run it under plain "
                    "spatial_devices)")
            if "mesh" in kinds and kinds & {"steinhardt", "q6",
                                            "coordination"}:
                raise ValueError(
                    "the mesh CV cannot be combined with steinhardt/"
                    "coordination CVs on a walkers x space product mesh: "
                    "the mixed set forces the vjp bias path, which would "
                    "transpose the nested FFT island (unsupported); use "
                    "mesh-only or order-CV-only runs")
        cvs, extra_attrs = _build_packed_cvs(
            cvs_cfg, spec, n, types, pos, system, smesh=smesh, box_L=L,
            smesh2d=smesh2d,
            nested=getattr(engine, "_nested_islands", False))
        if fene is not None:
            assert bonds is not None, "fene engine config needs melt init"
            extra_attrs.update(bond_partner_attrs(bonds, n))
        state, ovf = engine.pack_state(
            pos, box, jnp.asarray(types), eps_i=jnp.asarray(eps_i),
            sigma_i=jnp.asarray(sigma_i), vel=vel, extra_attrs=extra_attrs)
        assert not bool(ovf), "cell capacity overflow at pack"
        packed = True
    else:
        tables = {"lj": pair_mod.lj_tables, "wca": pair_mod.wca_tables,
                  "soft": pair_mod.soft_tables}
        kern = {"lj": pair_mod.lj_kernel, "wca": pair_mod.lj_kernel,
                "soft": pair_mod.soft_kernel}[pair["kind"]]
        tab_kwargs = {k: v for k, v in pair.items() if k != "kind"}
        params = tables[pair["kind"]](system.n_types, **tab_kwargs)
        engine = AllPairsEngine(system, pair_params=params, pair_kernel=kern,
                                row_block=int(eng_cfg.get("row_block", 1024)))
        state = make_state(pos, box, vel=vel)
        cvs = _build_particle_cvs(cvs_cfg, system, L, pos)
        packed = False

    integ = _integrator_factory(icfg, system, packed,
                                spec=spec if packed else None,
                                engine=engine if packed else None)
    if bool(icfg.get("box_bias", False)) and (n_walkers > 1
                                              or mode == "flux_tempered"):
        raise ValueError(
            "integrator.box_bias (box-shape metadynamics) needs the "
            "two-arg box-coupled integrator factory, which only the "
            "single-replica standard/well_tempered sampler supports")

    # --- metadynamics ----------------------------------------------------
    grid = _grid_from_cfg(cvs_cfg, mcfg)
    # Fail loudly on a misconfigured grid: a start far outside the bias
    # grid means clamped deposits at the edge node and — with wall_k —
    # enormous wall forces through the CV gradient from step 1 (instant
    # blowup that still exits rc=0).  The reference integrator errors on
    # out-of-bounds CVs (SURVEY.md §3.1); so do we, at build time.
    # wte is skipped: its value needs a force/energy pass we haven't run.
    if grid is not None:
        lo = np.asarray(grid.lo, np.float64)
        hi = np.asarray(grid.hi, np.float64)
        for d, (cv, c) in enumerate(zip(cvs, cvs_cfg)):
            if c["kind"] == "wte":
                continue
            if getattr(cv, "nested", False):
                # nested FFT islands only run inside the walker-manual
                # region; validate with the mathematically identical
                # single-device PackedMesh on the global state instead
                from .cv.packed import PackedMesh
                twin = PackedMesh.create(
                    cv.mesh_shape, None, n_real=cv.n_real, k0=cv.k0,
                    width=cv.width, name=cv.name,
                    assign_order=cv.assign_order)
                v = float(twin.value(state, system))
            else:
                v = float(cv.value(state, system))
            margin = 0.05 * (hi[d] - lo[d])
            if v < lo[d] - margin or v > hi[d] + margin:
                raise ValueError(
                    f"initial value of CV '{c['name']}' is {v:.6g}, outside "
                    f"its bias grid [{lo[d]:g}, {hi[d]:g}]. Deposits would "
                    f"clamp to the edge node and walls (wall_k) would apply "
                    f"huge forces from step 1 — fix grid.min/max for this "
                    f"CV (or its normalization).")
    # restart_from_grid: seed the bias from a previous run's grid dump and
    # keep depositing (the reference's restart_from_grid/add_bias path,
    # SURVEY.md §3.5) — unlike --resume this restarts the MD state fresh
    initial_bias = None
    if "restart_from_grid" in mcfg:
        from .io.grid_file import load_grid
        assert grid is not None, "restart_from_grid needs grid-mode CVs"
        initial_bias, _gmeta = load_grid(mcfg["restart_from_grid"])
        lspec = initial_bias.grid.spec
        assert tuple(lspec.shape) == tuple(grid.shape), (
            f"grid dump shape {tuple(lspec.shape)} != config grid "
            f"{tuple(grid.shape)}")
        assert (np.allclose(lspec.lo, grid.lo)
                and np.allclose(lspec.hi, grid.hi)), (
            "grid dump CV ranges differ from the config's grid ranges")
    walls = None
    if "wall_k" in mcfg:
        if grid is not None:
            walls = WallSpec.at_grid_edges(grid, k=float(mcfg["wall_k"]))
        else:
            # hill-list (non-grid) mode: walls from explicit per-CV bounds
            # (``wall: {min, max}`` on each cv entry) — previously the
            # wall_k was silently dropped here (round-2 weak #8)
            assert all("wall" in c for c in cvs_cfg), (
                "wall_k without a grid needs wall: {min, max} on every cv")
            walls = WallSpec(
                k=jnp.full(len(cvs_cfg), float(mcfg["wall_k"])),
                lo=jnp.asarray([float(c["wall"]["min"]) for c in cvs_cfg]),
                hi=jnp.asarray([float(c["wall"]["max"]) for c in cvs_cfg]))
    # resuming must append to the accumulated hill history, not truncate
    # it (the hill file is the offline sum_hills input) — round-2 advisor
    hill_overwrite = bool(out_cfg.get("overwrite", True)) and not resume
    # add_hills: false = frozen-bias production run (reference
    # ``mode_metadynamics(add_hills=False)``) — usually combined with
    # restart_from_grid to sample under a converged static bias
    add_hills = bool(mcfg.get("add_hills", True))
    # bias-force multiple-time-stepping (PLUMED MULTIPLE_TIME_STEP): CV
    # sweeps + grid interpolation every k steps, bias force held between
    bias_every = int(mcfg.get("bias_every", 1))

    def _stacked_walker_states():
        """Initial state replicated per walker (fresh velocities each) and
        the walker device mesh — the product mesh from the engine section
        when spatial_devices is set, a plain ("walkers",) mesh otherwise."""
        import jax as _jax
        from jax.sharding import Mesh

        def re_vel(w):
            r2 = np.random.default_rng(1000 + w)
            v = r2.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
            return v - v.mean(axis=0)
        if packed:
            def pack_one(w):
                st, ovf2 = engine.pack_state(
                    pos, box, jnp.asarray(types), eps_i=jnp.asarray(eps_i),
                    sigma_i=jnp.asarray(sigma_i), vel=re_vel(w),
                    extra_attrs=extra_attrs)
                assert not bool(ovf2)
                return st
            states = _jax.tree.map(lambda *xs: jnp.stack(xs),
                                   *[pack_one(w) for w in range(n_walkers)])
        else:
            states = _jax.tree.map(
                lambda *xs: jnp.stack(xs),
                *[make_state(pos, box, vel=re_vel(w))
                  for w in range(n_walkers)])
        if wmesh is not None:
            return states, wmesh
        devs = _jax.devices()
        assert len(devs) >= n_walkers, (
            f"{n_walkers} walkers need {n_walkers} devices, "
            f"have {len(devs)}")
        return states, Mesh(np.asarray(devs[:n_walkers]), ("walkers",))

    if mode == "flux_tempered":
        assert add_hills, (
            "add_hills: false is a hill-deposition concept; flux-tempered "
            "mode rebuilds its bias from histograms instead — use a long "
            "update_period (or standard mode + restart_from_grid) to hold "
            "the bias static")
        assert grid is not None, "flux-tempered mode needs a CV grid"
        fkw = dict(
            initial_bias=initial_bias,
            integrator_factory=integ, kT=kT,
            stride=int(mcfg["stride"]),
            update_period=int(mcfg.get("update_period", 20)),
            seed=int(cfg.get("seed", 0)), walls=walls,
            update_rule=mcfg.get("update_rule", "flux"),
            gain0=float(mcfg.get("gain0", 0.5)),
            gain_halflife=int(mcfg.get("gain_halflife", 20)),
            bias_every=bias_every,
            # equilibration gate (reference: bias rebuilt "after
            # equilibration criterion", SURVEY.md §3.4) — default ON
            min_round_trips=int(mcfg.get("min_round_trips", 1)),
            max_defer_periods=int(mcfg.get("max_defer_periods", 4)))
        if n_walkers > 1:
            # multi-walker flux tempering: W replicas under the shared
            # bias, visit/crossing histograms pooled at every update
            # (previously this combination was SILENTLY ignored — the
            # round-4 weak #1)
            states, fmesh = _stacked_walker_states()
            sampler = FluxTemperedSampler(
                system, states, engine, cvs=cvs, grid_spec=grid,
                mesh=fmesh, **fkw)
        else:
            sampler = FluxTemperedSampler(
                system, state, engine, cvs=cvs, grid_spec=grid, **fkw)
        return sampler, cfg

    hills = HillSpec.create(
        W=float(mcfg["W"]), stride=int(mcfg["stride"]),
        mode=mode, deltaT=float(mcfg.get("deltaT", 1.0)))

    if n_walkers > 1:
        assert grid is not None, "multi-walker mode needs a CV grid"
        states, wk_mesh = _stacked_walker_states()
        sampler = WalkerSampler(
            system, states, engine, cvs=cvs, grid_spec=grid, hills=hills,
            initial_bias=initial_bias,
            integrator_factory=integ,
            mesh=wk_mesh,
            seed=int(cfg.get("seed", 0)), walls=walls,
            hill_file=out_cfg.get("hill_file"),
            overwrite=hill_overwrite,
            chunks_per_block=int(cfg.get("chunks_per_block", 16)),
            add_hills=add_hills,
            bias_every=bias_every)
        return sampler, cfg

    sampler = MetadSampler(
        system, state, engine, cvs=cvs, grid_spec=grid, hills=hills,
        initial_bias=initial_bias,
        integrator_factory=integ, seed=int(cfg.get("seed", 0)),
        hill_file=out_cfg.get("hill_file"),
        overwrite=hill_overwrite,
        walls=walls,
        hill_sigma=[c.get("sigma", mcfg.get("sigma", 0.1)) for c in cvs_cfg]
        if grid is None else None,
        hill_capacity=int(mcfg.get("hill_capacity", 4096)),
        chunks_per_block=int(cfg.get("chunks_per_block", 16)),
        add_hills=add_hills,
        bias_every=bias_every,
    )
    return sampler, cfg


def load_config(path: str) -> dict:
    """Read a run config: ``.json`` with the standard library, anything
    else as YAML (needs PyYAML)."""
    with open(path) as f:
        if path.endswith(".json"):
            import json
            return json.load(f)
        try:
            import yaml
        except ImportError:
            raise SystemExit(
                f"reading {path} needs PyYAML, which is not installed; "
                "install it or write the config as .json") from None
        return yaml.safe_load(f)


def cmd_run(args) -> int:
    import jax
    # persistent compile cache (utils/cache.py: JAX_COMPILATION_CACHE_DIR,
    # else <repo>/.jax_cache on the GPU)
    from .utils.cache import enable_persistent_cache
    enable_persistent_cache()
    from .io.metrics import CSVLogger
    from .io.grid_file import dump_grid
    from .io.checkpoint import save_checkpoint, load_checkpoint
    from .io.trajectory import make_trajectory_writer
    from .sampler import MetadSampler

    cfg = load_config(args.config)
    sampler, cfg = build_sampler(cfg, resume=args.resume)
    out_cfg = cfg.get("output", {})
    logger = (CSVLogger(out_cfg["log_file"], overwrite=not args.resume)
              if "log_file" in out_cfg else None)
    ckpt_path = out_cfg.get("checkpoint")
    ckpt_every = int(out_cfg.get("checkpoint_every", 0))
    traj = (make_trajectory_writer(out_cfg["trajectory"],
                             overwrite=not args.resume)
            if "trajectory" in out_cfg else None)

    if args.resume:
        assert ckpt_path and os.path.exists(ckpt_path), (
            "--resume needs output.checkpoint pointing at an existing file")
        if hasattr(sampler, "load_checkpoint"):       # WalkerSampler
            sampler.load_checkpoint(ckpt_path)
        else:
            sampler.carry, _ = load_checkpoint(ckpt_path, sampler.carry)
        print(f"resumed from {ckpt_path}", flush=True)

    def save_ckpt():
        if not ckpt_path:
            return
        if hasattr(sampler, "save_checkpoint"):
            sampler.save_checkpoint(ckpt_path)
        else:
            save_checkpoint(ckpt_path, sampler.carry)

    n_steps = int(cfg["run"]["n_steps"])
    report = int(cfg["run"].get("report_every", n_steps))
    # periodic grid snapshots during the run — the reference's
    # ``dump_grid(fname, period)`` (SURVEY.md §3.5).  A literal ``{step}``
    # in output.grid_file writes a numbered sequence (grid evolution /
    # convergence analysis); otherwise the file is overwritten in place
    # (a live restart point, like checkpoint_every)
    grid_every = int(out_cfg.get("grid_every", 0))

    def dump_bias_grid(step=None):
        if not ("grid_file" in out_cfg and hasattr(sampler, "bias")
                and hasattr(sampler.bias, "grid")):
            return
        path = out_cfg["grid_file"]
        if step is not None and "{step}" in path:
            path = path.format(step=step)
        hills = getattr(sampler, "hills", None)
        dump_grid(path, sampler.bias,
                  mode=hills.mode if hills is not None else "flux_tempered",
                  deltaT=float(hills.deltaT) if hills is not None else 1.0)
        print(f"grid written to {path}", flush=True)

    done = 0
    warned_oog = False
    while done < n_steps:
        todo = min(report, n_steps - done)
        hist = sampler.run(todo)
        done += todo
        if logger:
            logger.append(hist)
        m = hist[-1]
        cv = np.asarray(m["cv"]).round(4)
        temp = np.asarray(m["temperature"])
        print(f"step {done}: T={np.mean(temp):.3f} "
              f"cv={cv.tolist()}", flush=True)
        # a cell/neighbor-list overflow means pair forces were silently
        # wrong — the run is invalid, refuse to continue (round-3 fix:
        # this used to exit rc=0 with garbage physics)
        if bool(np.any(np.asarray(m.get("nlist_overflow", False)))):
            save_ckpt()
            raise RuntimeError(
                f"cell-list overflow by step {done}: forces are invalid. "
                f"Raise engine.cap (or check for a blowup — e.g. a CV "
                f"grid/wall misconfiguration; see the log file).")
        if bool(np.any(np.asarray(m.get("cell_width_violation", False)))):
            save_ckpt()
            raise RuntimeError(
                f"cell width fell below r_cut+skin by step {done} (NPT "
                f"compression outran the static cell grid): the 27-cell "
                f"stencil no longer covers r_list and pairs are being "
                f"missed. Re-pack with a cell grid sized for the target "
                f"density (smaller initial box or larger skin).")
        if not warned_oog and bool(
                np.any(np.asarray(m.get("cv_out_of_grid", False)))):
            warned_oog = True
            print(f"warning: a CV left its bias grid by step {done}; "
                  f"deposits clamp to the edge node (widen grid.min/max "
                  f"if this persists)", file=sys.stderr, flush=True)
        if traj is not None and isinstance(sampler, MetadSampler):
            st = sampler.state
            if hasattr(st, "pos"):
                traj.append(np.asarray(st.pos), np.asarray(st.image),
                            np.asarray(st.box.L), done)
        if ckpt_every and (done % ckpt_every == 0):
            save_ckpt()
        if grid_every and (done % grid_every == 0) and done < n_steps:
            dump_bias_grid(step=done)
    save_ckpt()
    dump_bias_grid(step=n_steps)
    return 0


def _write_fes(path: str, coords, F, err=None) -> None:
    """Write an FES table: one row per grid node, CV coords then F (and
    optionally a block-analysis error column).

    PLUMED ``sum_hills`` emits the same layout (fes.dat); ``.npz`` output
    keeps the N-d arrays instead.
    """
    F = np.asarray(F)
    if path.endswith(".npz"):
        extra = {} if err is None else {"err": np.asarray(err)}
        np.savez(path, F=F, **{f"cv{i}": np.asarray(c)
                               for i, c in enumerate(coords)}, **extra)
        return
    mesh = np.meshgrid(*coords, indexing="ij")
    cols = [m.ravel() for m in mesh] + [F.ravel()]
    names = [f"cv{i}" for i in range(len(coords))] + ["free_energy"]
    if err is not None:
        cols.append(np.asarray(err).ravel())
        names.append("error")
    with open(path, "w") as f:
        f.write("#! FIELDS " + " ".join(names) + "\n")
        np.savetxt(f, np.stack(cols, axis=1), fmt="%.8g")


def cmd_sum_hills(args) -> int:
    """Offline FES reconstruction from a hill log (PLUMED ``sum_hills``
    equivalent; SURVEY.md §3.5)."""
    from .io.hill_log import read_hills, fes_from_hills

    h = read_hills(args.hills)
    if h["step"].size == 0:
        print("no hills in file", file=sys.stderr)
        return 1
    d = h["center"].shape[1]
    lo = (np.asarray([float(x) for x in args.min.split(",")])
          if args.min else h["center"].min(0) - 3.0 * h["sigma"].max(0))
    hi = (np.asarray([float(x) for x in args.max.split(",")])
          if args.max else h["center"].max(0) + 3.0 * h["sigma"].max(0))
    bins = [int(b) for b in args.bins.split(",")] if args.bins else [101] * d
    assert len(lo) == len(hi) == len(bins) == d, (
        f"hill file has {d} CVs; --min/--max/--bins must match")
    coords = [np.linspace(lo[i], hi[i], bins[i]) for i in range(d)]
    err = None
    if args.blocks:
        from .io.hill_log import fes_error_from_hills
        F, err = fes_error_from_hills(
            args.hills, coords, n_blocks=args.blocks, mode=args.mode,
            kT=args.kT, deltaT=args.deltaT)
        print(f"block analysis ({args.blocks} blocks): "
              f"mean err {err.mean():.4g}, max {err.max():.4g}")
    else:
        F = fes_from_hills(args.hills, coords, mode=args.mode, kT=args.kT,
                           deltaT=args.deltaT)
    _write_fes(args.out, coords, F, err=err)
    print(f"FES ({'x'.join(str(b) for b in bins)}, "
          f"range {F.max() - F.min():.4g}) written to {args.out}")
    return 0


def cmd_fes(args) -> int:
    """FES from a bias-grid dump (``dump_grid`` output): F = −V (standard)
    or −(kT+ΔT)/ΔT·V (well-tempered), shifted to min 0."""
    from .io.grid_file import load_grid

    bias, meta = load_grid(args.grid)
    V = np.asarray(bias.grid.V)
    mode, deltaT = meta["mode"], meta["deltaT"]
    if args.mode:
        mode = args.mode
    F = -V if mode in ("standard", "flux_tempered") \
        else -(args.kT + deltaT) / deltaT * V
    F = F - F.min()
    spec = bias.grid.spec
    coords = [np.linspace(float(spec.lo[i]), float(spec.hi[i]), spec.shape[i])
              for i in range(len(spec.shape))]
    _write_fes(args.out, coords, F)
    print(f"FES (mode={mode}, range {F.max():.4g}) written to {args.out}")
    return 0


def cmd_rdf(args) -> int:
    """g(r) of a dumped trajectory — offline analysis like the reference
    ecosystem's post-processing of GSD/DCD dumps."""
    from .io.trajectory import read_dcd, read_trajectory
    from .utils.analysis import rdf

    if args.traj.endswith(".gsd"):
        from .io.gsd_file import read_gsd_frames

        def read(path):
            frames = read_gsd_frames(path)
            return {
                "pos": np.stack([f["particles/position"] for f in frames]),
                "box_L": np.stack([f["configuration/box"][:3]
                                   for f in frames]),
            }
    else:
        read = read_dcd if args.traj.endswith(".dcd") else read_trajectory
    d = read(args.traj)
    pos, box_L = d["pos"][args.skip:], np.asarray(d["box_L"])
    if box_L.ndim == 2:
        box_L = box_L[args.skip:]
    assert pos.shape[0] > 0, "no frames left after --skip"
    r, g = rdf(pos, box_L, r_max=args.r_max, n_bins=args.bins)
    if args.out.endswith(".npz"):
        np.savez(args.out, r=r, g=g)
    else:
        np.savetxt(args.out, np.column_stack([r, g]),
                   header="r g(r)")
    print(f"rdf over {pos.shape[0]} frames -> {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="metadyn",
                                description="on-device metadynamics MD")
    sub = p.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser(
        "run", help="run a simulation from a YAML or JSON config")
    runp.add_argument("config")
    runp.add_argument("--resume", action="store_true",
                      help="resume from output.checkpoint")
    shp = sub.add_parser(
        "sum-hills",
        help="reconstruct the FES from a hill log (PLUMED sum_hills)")
    shp.add_argument("hills", help="hill log file (HILLS)")
    shp.add_argument("--out", default="fes.dat",
                     help="output table (.dat columns or .npz)")
    shp.add_argument("--min", help="comma-separated grid minima per CV")
    shp.add_argument("--max", help="comma-separated grid maxima per CV")
    shp.add_argument("--bins", help="comma-separated bin counts per CV")
    shp.add_argument("--mode", default="standard",
                     choices=["standard", "well_tempered"])
    shp.add_argument("--kT", type=float, default=1.0)
    shp.add_argument("--deltaT", type=float, default=1.0)
    shp.add_argument("--blocks", type=int, default=0,
                     help="time-block convergence analysis: snapshot the "
                          "cumulative FES N times, report the aligned "
                          "across-block std-dev as an extra column")
    fesp = sub.add_parser(
        "fes", help="FES from a bias-grid dump (output.grid_file)")
    fesp.add_argument("grid", help="grid dump (.npz from dump_grid)")
    fesp.add_argument("--out", default="fes.dat")
    fesp.add_argument("--mode", help="override the mode stored in the dump")
    fesp.add_argument("--kT", type=float, default=1.0)
    rdfp = sub.add_parser(
        "rdf", help="radial distribution function g(r) of a trajectory")
    rdfp.add_argument("traj", help="trajectory (.dcd or .npz)")
    rdfp.add_argument("--out", default="rdf.dat",
                      help="output table: r, g(r)")
    rdfp.add_argument("--bins", type=int, default=100)
    rdfp.add_argument("--r-max", type=float, default=None,
                      help="default: min(L)/2")
    rdfp.add_argument("--skip", type=int, default=0,
                      help="drop the first N frames (equilibration)")
    args = p.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "sum-hills":
        return cmd_sum_hills(args)
    if args.cmd == "fes":
        return cmd_fes(args)
    if args.cmd == "rdf":
        return cmd_rdf(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
