"""CLI coverage: every baseline config (1-5) expressed as YAML runs
through ``metadyn run`` (shrunk sizes — CPU smoke), plus checkpoint
--resume (VERDICT r1 item 9)."""
import os

import numpy as np
import pytest
import yaml

from metadyn_tpu.cli import main


def _shrunk(cfg_path, tmp_path, **over):
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(cfg, over)
    cfg.setdefault("chunks_per_block", 1)
    # route outputs into tmp
    out = cfg.setdefault("output", {})
    for k in ("hill_file", "log_file", "grid_file", "checkpoint",
              "trajectory"):
        if k in out:
            out[k] = str(tmp_path / os.path.basename(out[k]))
    p = tmp_path / "cfg.yaml"
    with open(p, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(p), cfg


def test_cli_config1(tmp_path):
    p, cfg = _shrunk("examples/config1_lj_lamellar.yaml", tmp_path,
                     run={"n_steps": 250, "report_every": 250})
    assert main(["run", p]) == 0
    assert os.path.exists(cfg["output"]["grid_file"])
    assert len(open(cfg["output"]["hill_file"]).readlines()) == 11


def test_cli_sum_hills_and_fes(tmp_path):
    """`metadyn sum-hills` (offline hill summation) and `metadyn fes`
    (grid dump) reconstruct the SAME free-energy surface — the PLUMED
    sum_hills workflow (SURVEY.md §3.5)."""
    p, cfg = _shrunk("examples/config1_lj_lamellar.yaml", tmp_path,
                     run={"n_steps": 250, "report_every": 250})
    assert main(["run", p]) == 0
    g = cfg["cvs"][0]["grid"]
    fes_h = str(tmp_path / "fes_hills.dat")
    fes_g = str(tmp_path / "fes_grid.npz")
    assert main(["sum-hills", cfg["output"]["hill_file"], "--out", fes_h,
                 "--min", str(g["min"]), "--max", str(g["max"]),
                 "--bins", str(g["num_points"])]) == 0
    assert main(["fes", cfg["output"]["grid_file"], "--out", fes_g]) == 0
    tab = np.loadtxt(fes_h)
    assert tab.shape == (g["num_points"], 2)
    F_h = tab[:, 1]
    z = np.load(fes_g)
    F_g = z["F"]
    np.testing.assert_allclose(z["cv0"], tab[:, 0], atol=1e-6)
    # same hills, two reconstruction routes: agree to file-text precision
    np.testing.assert_allclose(F_h, F_g, atol=5e-3)
    # auto-ranged reconstruction (no --min/--max) also works
    fes_a = str(tmp_path / "fes_auto.dat")
    assert main(["sum-hills", cfg["output"]["hill_file"],
                 "--out", fes_a]) == 0
    assert np.loadtxt(fes_a).shape[1] == 2


def test_cli_restart_from_grid(tmp_path):
    """`metadynamics.restart_from_grid` seeds the bias from a previous
    run's grid dump and keeps depositing (reference restart_from_grid /
    add_bias, SURVEY.md §3.5) — distinct from --resume, which restores
    the full MD state."""
    from metadyn_tpu.io.grid_file import load_grid

    p1, cfg1 = _shrunk("examples/config1_lj_lamellar.yaml", tmp_path,
                       run={"n_steps": 250, "report_every": 250})
    assert main(["run", p1]) == 0
    b0, _ = load_grid(cfg1["output"]["grid_file"])
    V0 = np.asarray(b0.grid.V)
    assert V0.max() > 0.0

    (tmp_path / "second").mkdir(exist_ok=True)
    p2, cfg2 = _shrunk(
        p1, tmp_path / "second",
        metadynamics={"restart_from_grid": cfg1["output"]["grid_file"]},
        run={"n_steps": 125, "report_every": 125})
    assert main(["run", p2]) == 0
    b1, _ = load_grid(cfg2["output"]["grid_file"])
    V1 = np.asarray(b1.grid.V)
    # standard mode only ADDS bias: the seeded grid is a lower bound, and
    # the continuation deposited 5 more hills on top
    assert (V1 - V0).min() > -1e-5
    assert (V1 - V0).max() > 0.0

    # mismatched grid must be rejected, not silently interpolated
    (tmp_path / "third").mkdir(exist_ok=True)
    p3, _ = _shrunk(p1, tmp_path / "third",
                    cvs=[dict(cfg1["cvs"][0],
                              grid=dict(cfg1["cvs"][0]["grid"],
                                        num_points=51))],
                    metadynamics={"restart_from_grid":
                                  cfg1["output"]["grid_file"]})
    with pytest.raises(AssertionError):
        main(["run", p3])


def test_cli_sum_hills_block_error(tmp_path):
    """`sum-hills --blocks N`: time-block convergence analysis appends an
    aligned across-block std-dev column to the FES table."""
    p, cfg = _shrunk("examples/config1_lj_lamellar.yaml", tmp_path,
                     run={"n_steps": 250, "report_every": 250})
    assert main(["run", p]) == 0
    out = str(tmp_path / "fes_err.dat")
    assert main(["sum-hills", cfg["output"]["hill_file"], "--out", out,
                 "--bins", "51", "--blocks", "4"]) == 0
    tab = np.loadtxt(out)
    assert tab.shape == (51, 3)
    err = tab[:, 2]
    assert np.isfinite(err).all() and err.min() >= 0.0 and err.max() > 0.0
    # npz output carries the err array too
    outz = str(tmp_path / "fes_err.npz")
    assert main(["sum-hills", cfg["output"]["hill_file"], "--out", outz,
                 "--bins", "51", "--blocks", "4"]) == 0
    z = np.load(outz)
    assert z["err"].shape == (51,)


def test_cli_rdf(tmp_path):
    """`metadyn rdf` computes g(r) from a dumped DCD trajectory — offline
    analysis parity with the reference ecosystem's post-processing."""
    p, cfg = _shrunk(
        "examples/config1_lj_lamellar.yaml", tmp_path,
        run={"n_steps": 250, "report_every": 125},
        output={"trajectory": str(tmp_path / "t.dcd")})
    assert main(["run", p]) == 0
    out = str(tmp_path / "rdf.dat")
    assert main(["rdf", cfg["output"]["trajectory"], "--out", out,
                 "--bins", "40"]) == 0
    tab = np.loadtxt(out)
    assert tab.shape == (40, 2)
    r, g = tab[:, 0], tab[:, 1]
    # dense LJ fluid: excluded core and a nonzero first peak
    assert g[r < 0.8].max() < 0.05 and g.max() > 1.2


def test_cli_grid_every_periodic_dumps(tmp_path):
    """`output.grid_every` dumps the bias grid during the run (reference
    ``dump_grid(fname, period)``, SURVEY.md §3.5); a `{step}` placeholder
    writes a numbered sequence showing the bias build-up."""
    from metadyn_tpu.io.grid_file import load_grid

    p, cfg = _shrunk(
        "examples/config1_lj_lamellar.yaml", tmp_path,
        run={"n_steps": 250, "report_every": 125},
        output={"grid_file": str(tmp_path / "g_{step}.npz"),
                "grid_every": 125})
    assert main(["run", p]) == 0
    b1, _ = load_grid(str(tmp_path / "g_125.npz"))
    b2, _ = load_grid(str(tmp_path / "g_250.npz"))
    assert int(b1.n_hills) == 5 and int(b2.n_hills) == 10
    dV = np.asarray(b2.grid.V) - np.asarray(b1.grid.V)
    assert dV.min() > -1e-5 and dV.max() > 0.0  # bias only grows


def test_cli_add_hills_false(tmp_path):
    """`metadynamics.add_hills: false` + `restart_from_grid` = frozen-bias
    production run (reference ``mode_metadynamics(add_hills=False)``): the
    seeded grid is applied as a static bias and comes back unchanged."""
    from metadyn_tpu.io.grid_file import load_grid

    p1, cfg1 = _shrunk("examples/config1_lj_lamellar.yaml", tmp_path,
                       run={"n_steps": 250, "report_every": 250})
    assert main(["run", p1]) == 0
    b0, _ = load_grid(cfg1["output"]["grid_file"])
    V0 = np.asarray(b0.grid.V)

    (tmp_path / "frozen").mkdir(exist_ok=True)
    p2, cfg2 = _shrunk(
        p1, tmp_path / "frozen",
        metadynamics={"restart_from_grid": cfg1["output"]["grid_file"],
                      "add_hills": False},
        run={"n_steps": 125, "report_every": 125})
    assert main(["run", p2]) == 0
    b1, _ = load_grid(cfg2["output"]["grid_file"])
    np.testing.assert_array_equal(np.asarray(b1.grid.V), V0)
    assert int(b1.n_hills) == int(b0.n_hills)
    # no hill rows are appended during a frozen run
    assert not os.path.exists(cfg2["output"]["hill_file"])


@pytest.mark.smoke
def test_cli_config6_wte(tmp_path):
    """`kind: wte` — the well-tempered-ensemble CV (total potential energy,
    reference WellTemperedEnsemble) through the CLI on the packed engine:
    with_energy auto-enabled, hills land on U, logged CV == live energy."""
    p, cfg = _shrunk(
        "examples/config6_wte.yaml", tmp_path,
        system={"init": {"kind": "fcc", "n_cells": 6, "a": 1.72}},
        cvs=[{"name": "U", "kind": "wte",
              "grid": {"min": -7500.0, "max": -1000.0,
                       "num_points": 131, "sigma": 70.0}}],
        metadynamics={"W": 1.0, "stride": 25, "mode": "well_tempered",
                      "deltaT": 3000.0},
        run={"n_steps": 250, "report_every": 250})
    assert main(["run", p]) == 0
    rows = [l for l in open(cfg["output"]["hill_file"])
            if not l.startswith("#")]
    assert len(rows) == 10
    u = np.array([float(r.split()[1]) for r in rows])
    # the CV is the live potential energy of an 864-particle LJ solid/liquid
    assert (-7500 < u).all() and (u < -1000).all()
    from metadyn_tpu.io.grid_file import load_grid
    bias, meta = load_grid(cfg["output"]["grid_file"])
    assert meta["mode"] == "well_tempered"
    assert float(np.asarray(bias.grid.V).max()) > 0.0


@pytest.mark.smoke
def test_cli_config2_mesh_melt(tmp_path):
    p, cfg = _shrunk(
        "examples/config2_diblock_sk.yaml", tmp_path,
        system={"init": {"n_chains": 40, "chain_len": 10, "box_L": 10.2,
                         "prerelax_steps": 400}},
        engine={"cap": 64},
        cvs=[{"name": "sk", "kind": "mesh", "mesh": [16, 16, 16],
              "k0": 2.45, "width": 0.4, "mode": [1.0, -1.0],
              # shrunk melt starts at S(k0) ~ 260 (round-3 fix: the old
              # {0, 40} grid put the start far outside, so the edge wall
              # blew the run up — silently, before the overflow check)
              "grid": {"min": 0.0, "max": 1200.0, "num_points": 41,
                       "sigma": 30.0}}],
        run={"n_steps": 200, "report_every": 200},
        metadynamics={"stride": 100})
    assert main(["run", p]) == 0
    assert os.path.exists(cfg["output"]["grid_file"])
    # the run must be REAL physics now: no overflow, healthy temperature
    import csv
    rows = list(csv.DictReader(open(cfg["output"]["log_file"])))
    assert all(r["nlist_overflow"] == "0" for r in rows)
    assert 0.3 < float(rows[-1]["temperature"]) < 3.0


@pytest.mark.smoke
def test_cli_config3_q6_coord(tmp_path):
    p, cfg = _shrunk(
        "examples/config3_nucleation_2dcv.yaml", tmp_path,
        system={"init": {"n_cells": 7}},
        engine={"cap": 64},
        run={"n_steps": 200, "report_every": 200},
        metadynamics={"stride": 100})
    assert main(["run", p]) == 0
    assert os.path.exists(cfg["output"]["grid_file"])
    rows = open(cfg["output"]["hill_file"]).readlines()
    assert len(rows) == 3  # header + 2 hills (2-D centers)
    assert len(rows[1].split()) == 6  # step, q6, coord, 2 sigmas, height


@pytest.mark.smoke
def test_cli_config4_walkers(tmp_path):
    p, cfg = _shrunk(
        "examples/config4_walkers.yaml", tmp_path,
        system={"init": {"n_cells": 6, "a": 1.71}},
        run={"n_steps": 40, "report_every": 40},
        metadynamics={"stride": 20})
    assert main(["run", p]) == 0
    rows = open(cfg["output"]["hill_file"]).readlines()
    assert len(rows) == 1 + 2 * 8  # 2 strides x 8 walkers


@pytest.mark.smoke
def test_cli_config5_flux(tmp_path):
    p, cfg = _shrunk(
        "examples/config5_flux.yaml", tmp_path,
        system={"init": {"n_chains": 30, "chain_len": 8, "box_L": 8.2,
                         "prerelax_steps": 400}},
        # shrunk box: LJ r_cut 2.5 + skin would need >=3 cells of 2.9
        engine={"pair": {"r_cut": 2.0}},
        run={"n_steps": 400, "report_every": 400},
        metadynamics={"stride": 50, "update_period": 2})
    assert main(["run", p]) == 0
    assert os.path.exists(cfg["output"]["grid_file"])


@pytest.mark.smoke
def test_cli_flux_resume(tmp_path):
    """Flux-tempered --resume restores the bias grid AND the gain
    schedule (round-2 advisor, medium: carry-only checkpoints silently
    restarted flux runs with a zero bias)."""
    p, cfg = _shrunk(
        "examples/config5_flux.yaml", tmp_path,
        system={"init": {"n_chains": 30, "chain_len": 8, "box_L": 8.2,
                         "prerelax_steps": 400}},
        engine={"pair": {"r_cut": 2.0}},
        run={"n_steps": 200, "report_every": 200},
        # ungated cadence: this test asserts the exact update count
        metadynamics={"stride": 50, "update_period": 2,
                      "min_round_trips": 0},
        output={"checkpoint": "ck.npz", "checkpoint_every": 200})
    assert main(["run", p]) == 0
    from metadyn_tpu.io.grid_file import load_grid
    b1, _ = load_grid(cfg["output"]["grid_file"])
    v1 = np.asarray(b1.grid.V)
    assert np.abs(v1).max() > 0
    # a freshly built sampler + load_checkpoint must see the saved bias
    from metadyn_tpu.cli import build_sampler
    with open(p) as f:
        s2, _ = build_sampler(yaml.safe_load(f), resume=True)
    s2.load_checkpoint(cfg["output"]["checkpoint"])
    assert np.allclose(np.asarray(s2.bias.grid.V), v1)
    assert s2.n_updates == 2
    # and the CLI end-to-end resume path runs
    assert main(["run", p, "--resume"]) == 0


def test_cli_walls_hill_list(tmp_path):
    """wall_k in hill-list (non-grid) mode builds walls from per-CV
    wall: {min, max} bounds instead of being silently dropped
    (round-2 weak #8)."""
    p, cfg = _shrunk(
        "examples/config1_lj_lamellar.yaml", tmp_path,
        cvs=[{"name": "lam", "kind": "lamellar",
              "lattice_vector": [0, 0, 1], "mode": [1.0],
              "sigma": 0.02, "wall": {"min": -0.4, "max": 0.4}}],
        metadynamics={"W": 0.2, "stride": 25, "mode": "standard",
                      "wall_k": 500.0},
        run={"n_steps": 50, "report_every": 50})
    # grid_file output requires a grid bias; drop it for hill-list mode
    with open(p) as f:
        c = yaml.safe_load(f)
    c["output"].pop("grid_file", None)
    with open(p, "w") as f:
        yaml.safe_dump(c, f)
    from metadyn_tpu.cli import build_sampler
    sampler, _ = build_sampler(c)
    assert sampler.walls is not None
    assert np.allclose(np.asarray(sampler.walls.lo), [-0.4])
    assert np.allclose(np.asarray(sampler.walls.hi), [0.4])
    assert main(["run", p]) == 0


def test_cli_checkpoint_resume(tmp_path):
    base = dict(
        system={"init": {"kind": "fcc", "n_cells": 4, "a": 1.8}},
        run={"n_steps": 100, "report_every": 50},
        output={"checkpoint": "ck.npz", "checkpoint_every": 50,
                "grid_file": "g.npz"})
    p, cfg = _shrunk("examples/config1_lj_lamellar.yaml", tmp_path, **base)
    assert main(["run", p]) == 0
    ck = cfg["output"]["checkpoint"]
    assert os.path.exists(ck)
    from metadyn_tpu.io.grid_file import load_grid
    b1, _ = load_grid(cfg["output"]["grid_file"])
    # resume continues from the checkpoint (bias keeps growing)
    assert main(["run", p, "--resume"]) == 0
    b2, _ = load_grid(cfg["output"]["grid_file"])
    assert int(b2.n_hills) > int(b1.n_hills)


@pytest.mark.smoke
def test_cli_spatial_dd(tmp_path):
    """engine.spatial_devices shards the packed cell grid over devices
    straight from YAML — the reference's `mpirun -n N` spatial domain
    decomposition as one config key (SURVEY.md §2b Communicator row).
    Uses the mesh CV so the YAML path maps onto the distributed slab FFT
    (lamellar-under-DD is covered by test_spatial's stepping
    differential).  Builds ONCE and drives the sampler directly: the
    spatial force tracing costs minutes on the 1-CPU suite host, and the
    `main` run-loop plumbing is covered by the other CLI tests."""
    import yaml as _yaml

    cfg = dict(
        system={"init": {"kind": "sc", "n_per_side": 5, "spacing": 2.4},
                "kT": 1.0},
        engine={"kind": "packed", "spatial_devices": 2, "skin": 0.5,
                "rebuild_every": 2, "cap": 16,
                "pair": {"kind": "lj", "r_cut": 2.5}},
        integrator={"kind": "langevin", "dt": 0.004, "gamma": 1.0},
        cvs=[{"name": "sk", "kind": "mesh", "mesh": [8, 8, 8], "k0": 1.57,
              "width": 0.5, "mode": [1.0],
              # sc lattice starts at S(k0) ~ 37; leave headroom so biased
              # excursions stay on-grid
              "grid": {"min": 0.0, "max": 150.0, "num_points": 31,
                       "sigma": 7.5}}],
        metadynamics={"W": 0.3, "stride": 10, "mode": "well_tempered",
                      "deltaT": 5.0},
        run={"n_steps": 20, "report_every": 20},
        chunks_per_block=1,
        output={"hill_file": str(tmp_path / "HILLS"),
                "grid_file": str(tmp_path / "g.npz")})
    p = tmp_path / "spatial.yaml"
    with open(p, "w") as f:
        _yaml.safe_dump(cfg, f)

    from metadyn_tpu.cli import build_sampler
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.mesh import ShardedPackedMesh
    sampler, _ = build_sampler(cfg)
    assert isinstance(sampler.engine, SpatialPackedEngine)
    assert isinstance(sampler.cvs[0], ShardedPackedMesh)
    hist = sampler.run(20)
    m = hist[-1]
    assert np.isfinite(np.asarray(m["cv"])).all()
    assert not bool(m["nlist_overflow"])
    assert int(sampler.bias.n_hills) == 2
    assert len(open(tmp_path / "HILLS").readlines()) >= 3  # header + 2 hills

    # order CVs under spatial DD straight from YAML (round-3 VERDICT
    # item 3: the library path was tested but cli raised) — build + one
    # stride; the full differential lives in
    # test_spatial.py::test_order_cvs_under_spatial_dd
    c3 = _yaml.safe_load(open(p))
    c3["cvs"] = [{"name": "q6", "kind": "steinhardt", "r_cut": 2.6,
                  "grid": {"min": 0.0, "max": 0.6, "num_points": 11,
                           "sigma": 0.02}},
                 {"name": "co", "kind": "coordination", "r0": 1.6,
                  "grid": {"min": 0.0, "max": 20.0, "num_points": 11,
                           "sigma": 0.5}}]
    c3["output"] = {}
    s3, _ = build_sampler(c3)
    assert isinstance(s3.engine, SpatialPackedEngine)
    h3 = s3.run(10)
    assert np.isfinite(np.asarray(h3[-1]["cv"])).all()
    assert not bool(h3[-1]["nlist_overflow"])

    # walkers x spatial x mesh CV: the full product-mesh composition now
    # builds from YAML — the slab-FFT island nests under the walker axis
    # (round-4 VERDICT missing #1a; Config-4-at-scale with an S(k) CV)
    c4 = _yaml.safe_load(open(p))
    c4["metadynamics"]["n_walkers"] = 2
    c4["output"] = {}
    s4, _ = build_sampler(c4)
    from metadyn_tpu.parallel.mesh import ShardedPackedMesh
    assert isinstance(s4.cvs[0], ShardedPackedMesh) and s4.cvs[0].nested
    h4 = s4.run(10)
    assert np.isfinite(np.asarray(h4[-1]["cv"])).all()
    assert not np.any(np.asarray(h4[-1]["nlist_overflow"]))


@pytest.mark.smoke
def test_cli_walkers_times_spatial(tmp_path):
    """metadynamics.n_walkers together with engine.spatial_devices builds
    the walkers x space product mesh from YAML — the reference's
    ``mpirun -n W*S --nrank W`` (W partitions, each internally
    domain-decomposed).  2 walkers x 2 shards on the CPU mesh; builds
    once and drives the sampler directly (CLI loop covered elsewhere)."""
    cfg = dict(
        system={"init": {"kind": "sc", "n_per_side": 5, "spacing": 2.4},
                "kT": 1.0},
        engine={"kind": "packed", "spatial_devices": 2, "skin": 0.5,
                "rebuild_every": 2, "cap": 16,
                "pair": {"kind": "lj", "r_cut": 2.5}},
        integrator={"kind": "langevin", "dt": 0.004, "gamma": 1.0},
        cvs=[{"name": "lam", "kind": "lamellar", "lattice_vector": [0, 0, 2],
              "mode": [1.0],
              "grid": {"min": -0.5, "max": 0.5, "num_points": 31,
                       "sigma": 0.02}}],
        metadynamics={"W": 0.3, "stride": 10, "mode": "well_tempered",
                      "deltaT": 5.0, "n_walkers": 2},
        run={"n_steps": 20, "report_every": 20},
        chunks_per_block=1,
        output={"hill_file": str(tmp_path / "HILLS")})

    from metadyn_tpu.cli import build_sampler
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.walkers import WalkerSampler
    sampler, _ = build_sampler(cfg)
    assert isinstance(sampler, WalkerSampler)
    assert isinstance(sampler.engine, SpatialPackedEngine)
    assert sampler.engine._nested_islands
    assert sampler.mesh.axis_names == ("walkers", "space")
    hist = sampler.run(20)
    m = hist[-1]
    assert np.isfinite(np.asarray(m["cv"])).all()
    assert not np.any(np.asarray(m["nlist_overflow"]))
    assert int(sampler.bias.n_hills) == 4          # 2 strides x 2 walkers
    assert len(open(tmp_path / "HILLS").readlines()) >= 5  # header + 4

    # order CVs build on the product mesh too (round-4: the roll-sweep
    # CVs run under the walker-manual region with "space" on GSPMD)
    q6 = dict(cfg)
    # r_cut must reach the sc nearest neighbors (spacing 2.4) or Q6=0/0
    q6["cvs"] = [{"name": "q6", "kind": "steinhardt", "r_cut": 2.6,
                  "grid": {"min": 0.0, "max": 0.7, "num_points": 31,
                           "sigma": 0.02}}]
    q6["output"] = {"hill_file": str(tmp_path / "HILLS_q6")}
    s_q6, _ = build_sampler(q6)
    h_q6 = s_q6.run(10)
    assert np.isfinite(np.asarray(h_q6[-1]["cv"])).all()

    # the one still-unsupported CV combination on the product mesh (mesh
    # CV mixed with order CVs — the mixed bias path would transpose the
    # nested FFT island) fails loudly, not silently
    import pytest as _pytest
    bad = dict(cfg)
    bad["cvs"] = [{"name": "sk", "kind": "mesh", "mesh": [8, 8, 8],
                   "k0": 1.57, "mode": [1.0],
                   "grid": {"min": 0.0, "max": 150.0, "num_points": 31,
                            "sigma": 7.5}},
                  {"name": "q6", "kind": "steinhardt", "r_cut": 2.6,
                   "grid": {"min": 0.0, "max": 0.7, "num_points": 31,
                            "sigma": 0.02}}]
    with _pytest.raises(ValueError, match="product mesh"):
        build_sampler(bad)


def test_cli_triclinic_packed(tmp_path):
    """system.tilt on the packed production engine: biased MD in a tilted
    cell through the CLI (examples/triclinic_packed.yaml, shrunk)."""
    p, cfg = _shrunk(
        "examples/triclinic_packed.yaml", tmp_path,
        system={"init": {"n_cells": 7}},
        run={"n_steps": 100, "report_every": 100},
        metadynamics={"stride": 50})
    assert main(["run", p]) == 0
    rows = open(cfg["output"]["hill_file"]).readlines()
    assert len(rows) >= 2  # header + >=1 hill deposited in the tilted box


@pytest.mark.parametrize("section,key", [
    ("metadynamics", "mts_lag"), ("engine", "pair_pallas"),
    ("engine", "order_pallas")])
def test_cli_want_lag_gating(section, key):
    """Keys of removed modes (the lagged fused MTS, the per-kernel Pallas
    switches) fail at build time with a message naming the key, instead
    of being silently ignored."""
    from metadyn_tpu.cli import build_sampler
    cfg = {"system": {"init": {"kind": "sc", "n_per_side": 4,
                               "spacing": 1.5}},
           "engine": {"kind": "packed"},
           "cvs": [{"name": "x", "kind": "lamellar", "lattice_vector": [0, 0, 1],
                    "grid": {"min": -1.0, "max": 1.0, "num_points": 16,
                             "sigma": 0.1}}],
           "metadynamics": {"W": 0.1, "stride": 10}}
    cfg[section][key] = True
    with pytest.raises(ValueError, match=f"{section}.{key}"):
        build_sampler(cfg)


def test_cli_reads_json_config(tmp_path):
    """cli.load_config: .json configs load with the standard library."""
    import json
    from metadyn_tpu.cli import load_config
    cfg = {"engine": {"kind": "packed"}, "run": {"n_steps": 10}}
    p = tmp_path / "c.json"
    p.write_text(json.dumps(cfg))
    assert load_config(str(p)) == cfg


def test_cli_mesh_assign_tsc(tmp_path):
    """cvs.assign: tsc builds a TSC-window mesh CV on both the single-chip
    packed path and the distributed slab FFT (the halo bound covers both
    windows: each spans at most floor(f)±1 columns)."""
    import pytest as _pytest
    from metadyn_tpu.cli import build_sampler
    cfg = dict(
        system={"init": {"kind": "sc", "n_per_side": 5, "spacing": 2.4},
                "kT": 1.0},
        engine={"kind": "packed", "skin": 0.5, "cap": 16,
                "pair": {"kind": "lj", "r_cut": 2.5}},
        integrator={"kind": "langevin", "dt": 0.004, "gamma": 1.0},
        cvs=[{"name": "sk", "kind": "mesh", "mesh": [8, 8, 8], "k0": 1.57,
              "width": 0.5, "mode": [1.0], "assign": "tsc",
              "grid": {"min": 0.0, "max": 150.0, "num_points": 31,
                       "sigma": 7.5}}],
        metadynamics={"W": 0.3, "stride": 10, "mode": "well_tempered",
                      "deltaT": 5.0},
        run={"n_steps": 20, "report_every": 20},
        output={"hill_file": str(tmp_path / "HILLS"),
                "grid_file": str(tmp_path / "g.npz")})
    sampler, _ = build_sampler(cfg)
    assert sampler.cvs[0].assign_order == 3
    hist = sampler.run(10)
    assert np.isfinite(np.asarray(hist[-1]["cv"])).all()

    dd = dict(cfg)
    dd["engine"] = {**cfg["engine"], "spatial_devices": 2}
    sampler_dd, _ = build_sampler(dd)
    assert sampler_dd.cvs[0].assign_order == 3
    hist_dd = sampler_dd.run(10)
    np.testing.assert_allclose(np.asarray(hist_dd[-1]["cv"]),
                               np.asarray(hist[-1]["cv"]), rtol=1e-3)
    bad2 = dict(cfg)
    bad2["cvs"] = [{**cfg["cvs"][0], "assign": "nearest"}]
    with _pytest.raises(ValueError, match="cic or tsc"):
        build_sampler(bad2)


def test_cli_npt_wte_under_spatial_dd(tmp_path):
    """integrator npt_scr + a wte CV together with engine.spatial_devices
    builds the with_energy sharded engine from YAML (round 4 — the old
    CLI refused this combination outright)."""
    from metadyn_tpu.cli import build_sampler
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    cfg = dict(
        system={"init": {"kind": "sc", "n_per_side": 6, "spacing": 1.6},
                "kT": 1.2},
        engine={"kind": "packed", "spatial_devices": 2, "skin": 0.4,
                "rebuild_every": 2, "cap": 24,
                "pair": {"kind": "lj", "r_cut": 2.0}},
        integrator={"kind": "npt_scr", "dt": 0.002, "gamma": 2.0,
                    "pressure": 1.0, "tau_p": 1.0},
        cvs=[{"name": "u", "kind": "wte",
              "grid": {"min": -8000.0, "max": 0.0, "num_points": 81,
                       "sigma": 100.0}}],
        metadynamics={"W": 2.0, "stride": 10, "mode": "well_tempered",
                      "deltaT": 20.0},
        run={"n_steps": 20, "report_every": 20},
        chunks_per_block=1,
        output={"hill_file": str(tmp_path / "HILLS")})
    sampler, _ = build_sampler(cfg)
    assert isinstance(sampler.engine, SpatialPackedEngine)
    assert sampler.engine.pair_path == "xla" and sampler.engine.virial_live
    hist = sampler.run(20)
    m = hist[-1]
    assert np.isfinite(np.asarray(m["cv"])).all()
    assert not np.any(np.asarray(m["nlist_overflow"]))
    assert int(sampler.bias.n_hills) == 2
    L3 = np.asarray(sampler.state.box.L)
    assert np.all(np.isfinite(L3)) and np.all(L3 > 0)


@pytest.mark.smoke
def test_cli_flux_walkers(tmp_path):
    """mode: flux_tempered + n_walkers: 8 from YAML builds the
    multi-walker FluxTemperedSampler with POOLED histograms (round-4
    VERDICT weak #1: this combination used to be SILENTLY ignored — an
    8-walker FT YAML ran ONE walker and exited 0).  Also covers the
    YAML-exposed equilibration gate (min_round_trips)."""
    from metadyn_tpu.cli import build_sampler
    from metadyn_tpu.flux_sampler import FluxTemperedSampler

    cfg = dict(
        seed=0,
        system={"init": {"kind": "sc", "n_per_side": 5, "spacing": 2.4}},
        engine={"kind": "packed", "skin": 0.5, "rebuild_every": 2,
                "cap": 16, "pair": {"kind": "lj", "r_cut": 2.5}},
        integrator={"kind": "langevin", "dt": 0.004, "kT": 1.0,
                    "gamma": 1.0},
        cvs=[{"name": "lam", "kind": "lamellar",
              "lattice_vector": [0, 0, 2],
              "grid": {"min": -0.5, "max": 0.5, "num_points": 31,
                       "sigma": 0.02}}],
        metadynamics={"mode": "flux_tempered", "stride": 10,
                      "update_period": 2, "n_walkers": 8,
                      "min_round_trips": 0, "max_defer_periods": 2},
        run={"n_steps": 20, "report_every": 20},
        output={})
    s, _ = build_sampler(cfg)
    assert isinstance(s, FluxTemperedSampler)
    assert s.n_walkers == 8
    assert s.min_round_trips == 0 and s.max_defer_periods == 2
    h = s.run(20)              # one update period per walker
    # POOLED per-walker histograms (the FT analog of the WT hill psum)
    assert tuple(s.carry.flux.hist.shape) == (8, 31)
    assert s.n_updates == 1    # ungated → the period applied its update
    assert np.isfinite(np.asarray(s.bias.grid.V)).all()
    assert np.isfinite(np.asarray(h[-1]["cv"])).all()

    # the gate default (min_round_trips=1) reaches the sampler from YAML
    cfg2 = dict(cfg)
    cfg2["metadynamics"] = {"mode": "flux_tempered", "stride": 10,
                            "update_period": 2, "n_walkers": 2}
    s2, _ = build_sampler(cfg2)
    assert s2.min_round_trips == 1 and s2.n_walkers == 2


@pytest.mark.smoke
def test_cli_flux_walkers_times_spatial(tmp_path):
    """mode: flux_tempered + n_walkers + spatial_devices: the FT sampler
    on the walkers x space product mesh from YAML (partition walkers,
    each domain-decomposed — with the FT histograms pooled across
    walkers at each update)."""
    from metadyn_tpu.cli import build_sampler
    from metadyn_tpu.flux_sampler import FluxTemperedSampler
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine

    cfg = dict(
        seed=0,
        system={"init": {"kind": "sc", "n_per_side": 5, "spacing": 2.4}},
        engine={"kind": "packed", "spatial_devices": 2, "skin": 0.5,
                "rebuild_every": 2, "cap": 16,
                "pair": {"kind": "lj", "r_cut": 2.5}},
        integrator={"kind": "langevin", "dt": 0.004, "kT": 1.0,
                    "gamma": 1.0},
        cvs=[{"name": "lam", "kind": "lamellar",
              "lattice_vector": [0, 0, 2],
              "grid": {"min": -0.5, "max": 0.5, "num_points": 31,
                       "sigma": 0.02}}],
        metadynamics={"mode": "flux_tempered", "stride": 10,
                      "update_period": 2, "n_walkers": 2,
                      "min_round_trips": 0},
        run={"n_steps": 20, "report_every": 20},
        output={})
    s, _ = build_sampler(cfg)
    assert isinstance(s, FluxTemperedSampler)
    assert isinstance(s.engine, SpatialPackedEngine)
    assert s.engine._nested_islands
    assert s.mesh.axis_names == ("walkers", "space")
    h = s.run(20)
    assert tuple(s.carry.flux.hist.shape) == (2, 31)
    assert s.n_updates == 1
    assert np.isfinite(np.asarray(s.bias.grid.V)).all()
    assert np.isfinite(np.asarray(h[-1]["cv"])).all()


@pytest.mark.smoke
def test_cli_box_metadynamics_packed_and_dd(tmp_path):
    """Box-shape metadynamics from YAML on the PACKED engine (kind:
    aspect_ratio + integrator npt_scr box_bias) — previously only the
    all-pairs engine could express it — and the same config under
    engine.spatial_devices: 2 (round-4 VERDICT missing #3: the reference
    runs box-shape metadynamics under its ordinary MPI DD)."""
    from metadyn_tpu.cli import build_sampler
    from metadyn_tpu.cv.aspect_ratio import AspectRatio
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine

    cfg = dict(
        seed=0,
        system={"init": {"kind": "fcc", "n_cells": 6, "a": 1.6}},
        engine={"kind": "packed", "skin": 0.3, "rebuild_every": 5,
                "cap": 24, "pair": {"kind": "lj", "r_cut": 2.0}},
        integrator={"kind": "npt_scr", "dt": 0.002, "kT": 1.0,
                    "gamma": 2.0, "pressure": 0.5, "tau_p": 1.0,
                    "anisotropic": True, "box_bias": True},
        cvs=[{"name": "ar", "kind": "aspect_ratio",
              "grid": {"min": 0.6, "max": 1.6, "num_points": 41,
                       "sigma": 0.03}}],
        metadynamics={"W": 0.3, "stride": 25, "mode": "well_tempered",
                      "deltaT": 4.0},
        run={"n_steps": 50, "report_every": 50},
        chunks_per_block=1, output={})
    s, _ = build_sampler(cfg)
    assert isinstance(s.cvs[0], AspectRatio)
    assert s.engine.virial_live        # npt_scr forced with_energy
    h = s.run(50)
    assert np.isfinite(np.asarray(h[-1]["cv"])).all()
    L3 = np.asarray(s.state.box.L)
    assert np.all(np.isfinite(L3)) and np.all(L3 > 0)
    assert int(s.bias.n_hills) == 2

    dd = dict(cfg)
    dd["engine"] = dict(cfg["engine"], spatial_devices=2)
    s2, _ = build_sampler(dd)
    assert isinstance(s2.engine, SpatialPackedEngine)
    assert s2.engine.virial_live
    h2 = s2.run(50)
    assert np.isfinite(np.asarray(h2[-1]["cv"])).all()
    assert int(s2.bias.n_hills) == 2

    # box_bias composes only with the single-replica WT sampler: walkers
    # and flux mode fail loudly
    bad = dict(cfg)
    bad["metadynamics"] = dict(cfg["metadynamics"], n_walkers=2)
    with pytest.raises(ValueError, match="box_bias"):
        build_sampler(bad)


@pytest.mark.smoke
def test_cli_config4_sk_product_mesh(tmp_path):
    """The flagship round-5 composition END-TO-END from the example YAML:
    Config-4-at-scale — 4 walkers x 2 spatial shards with the S(k)
    mesh CV (nested slab-FFT islands) — through ``metadyn run``."""
    p, cfg = _shrunk("examples/config4_walkers_sk_dd.yaml", tmp_path,
                     run={"n_steps": 40, "report_every": 40},
                     metadynamics={"stride": 20})
    assert main(["run", p]) == 0
    rows = open(cfg["output"]["hill_file"]).readlines()
    assert len(rows) == 1 + 2 * 4      # 2 strides x 4 walkers


@pytest.mark.smoke
def test_cli_triclinic_spatial_dd(tmp_path):
    """system.tilt + engine.spatial_devices from YAML (round 5: HOOMD
    runs tilted cells under its MPI decomposition; the 1-D slab DD now
    does too — fractional binning, a1-seam ghost shifts).  Shrunk
    triclinic Q6 config on a 2-shard mesh; the 2-D decomposition and the
    distributed-FFT mesh CV stay loudly excluded."""
    from metadyn_tpu.cli import build_sampler
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine

    p, cfg = _shrunk(
        "examples/triclinic_packed.yaml", tmp_path,
        # L = 12.96 with this tilt -> 4 x-cells: divisible by 2 shards
        system={"init": {"n_cells": 8, "a": 1.62}},
        engine={"spatial_devices": 2, "cap": 40},
        run={"n_steps": 50, "report_every": 50},
        metadynamics={"stride": 25})
    s, _ = build_sampler(cfg)
    assert isinstance(s.engine, SpatialPackedEngine)
    assert s.state.box.tilt is not None
    h = s.run(50)
    assert np.isfinite(np.asarray(h[-1]["cv"])).all()
    assert not bool(h[-1]["nlist_overflow"])
    assert int(s.bias.n_hills) == 2

    bad = dict(cfg)
    bad["engine"] = dict(cfg["engine"], spatial_devices=[2, 2])
    with pytest.raises(AssertionError, match="2-D decomposition"):
        build_sampler(bad)
    bad2 = dict(cfg)
    bad2["cvs"] = [{"name": "sk", "kind": "mesh", "mesh": [8, 8, 8],
                    "k0": 1.5, "mode": [1.0],
                    "grid": {"min": 0.0, "max": 400.0, "num_points": 31,
                             "sigma": 20.0}}]
    with pytest.raises(AssertionError, match="orthorhombic-only"):
        build_sampler(bad2)
