"""2-D spatial decomposition (parallel/spatial2d): force + migration +
biased-MD parity vs the single-device engine.

Reference parity: HOOMD's 3-D sub-box ``Communicator`` (SURVEY.md §2b);
the 1-D slab module caps at cx devices — the 2-D mesh is the named
extension (round-3 VERDICT missing #6).  The test mesh is 2×2 over the
8-virtual-device CPU backend.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from metadyn_tpu.core.box import Box
from metadyn_tpu.core.packed_engine import PackedEngine
from metadyn_tpu.core.state import make_system
from metadyn_tpu.ops.packed import PackedSpec, unpack_positions
from metadyn_tpu.parallel.spatial2d import SpatialPackedEngine2D
from metadyn_tpu.integrate.packed import make_packed_langevin_step


def _case(n_side=6, L=12.0, seed=0, jitter=0.15):
    sp = L / n_side
    sites = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * sp - L / 2 + 0.5
    rng = np.random.default_rng(seed)
    pos = (sites + rng.uniform(-jitter, jitter, sites.shape)) \
        .astype(np.float32)
    n = pos.shape[0]
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    return pos, vel, n, Box.cubic(L)


def _mesh2d():
    devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
    return Mesh(devs, ("spacex", "spacey"))


def test_2d_force_matches_single_device():
    pos, vel, n, box = _case()
    L = float(box.L[0])
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    eng_ref = PackedEngine(spec, pair_path="xla")
    eng_2d = SpatialPackedEngine2D(spec, _mesh2d())

    def forces(engine):
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32), vel=vel)
        assert not bool(ovf)
        st = jax.jit(lambda s: engine.force_into(s, None))(st)
        return (np.asarray(st.f), float(st.potential_energy),
                np.asarray(st.virial))

    f_r, e_r, w_r = forces(eng_ref)
    f_2, e_2, w_2 = forces(eng_2d)
    scale = np.abs(f_r).max()
    np.testing.assert_allclose(f_2, f_r, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(e_2, e_r, rtol=1e-5)
    np.testing.assert_allclose(w_2, w_r, rtol=1e-4)


def test_2d_repack_bit_identical_to_single_device():
    """The 2-D sharded migration assigns the SAME slots as the
    single-device incremental repack — through x, y AND corner
    (diagonal) ownership handoffs."""
    from metadyn_tpu.ops.packed import repack_incremental

    pos, vel, n, box = _case(jitter=0.3)
    L = float(box.L[0])
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    eng = PackedEngine(spec, pair_path="xla")
    st, ovf = eng.pack_state(pos, box, np.zeros(n, np.int32),
                             eps_i=np.ones(n, np.float32),
                             sigma_i=np.ones(n, np.float32), vel=vel)
    assert not bool(ovf)
    # push every particle by a random sub-cell displacement (many cross
    # x/y/z cell boundaries, including diagonals = corner handoffs)
    rng = np.random.default_rng(3)
    dr = jnp.asarray(rng.uniform(-1.4, 1.4, (3, st.r.shape[1])),
                     jnp.float32)
    st = st.replace(r=st.r + dr)

    ref, bad_ref = jax.jit(lambda s: repack_incremental(s, spec))(st)
    assert not bool(bad_ref)
    eng2 = SpatialPackedEngine2D(spec, _mesh2d())
    got, bad_2 = jax.jit(eng2._sharded_repack)(st)
    assert not bool(bad_2)

    np.testing.assert_array_equal(np.asarray(got.pid), np.asarray(ref.pid))
    np.testing.assert_array_equal(np.asarray(got.slot_of),
                                  np.asarray(ref.slot_of))
    np.testing.assert_allclose(np.asarray(got.r), np.asarray(ref.r),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.image),
                                  np.asarray(ref.image))


@pytest.mark.smoke
def test_2d_biased_md_matches_single_device():
    """100 biased MD steps (WT metadynamics on a lamellar CV) on the 2×2
    mesh match the single-device run — migration, halos and CV psum all
    exercised (the 2-D analog of test_spatial's stepping differential)."""
    from metadyn_tpu.sampler import MetadSampler
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED

    pos, vel, n, box = _case()
    L = float(box.L[0])
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    cv = PackedLamellar.create([[0, 0, 2]], n_real=n, name="lam")
    amps = np.ones(n, np.float32)
    system = make_system(n)

    def build(engine):
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32), vel=vel,
            extra_attrs={cv.attr_name: amps})
        assert not bool(ovf)
        return MetadSampler(
            system, st, engine, cvs=[cv],
            grid_spec=GridSpec.create([-0.5], [0.5], [51], [0.02]),
            hills=HillSpec.create(W=0.5, stride=25, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.004, kT=1.0, gamma=1.0),
            seed=0, chunks_per_block=1)

    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla"))
    h_ref = s_ref.run(100)
    s_2d = build(SpatialPackedEngine2D(spec, _mesh2d(), rebuild_every=5))
    h_2d = s_2d.run(100)

    m_r, m_2 = h_ref[-1], h_2d[-1]
    assert not bool(m_2["nlist_overflow"])
    np.testing.assert_allclose(np.asarray(m_2["cv"]),
                               np.asarray(m_r["cv"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(m_2["potential_energy"]),
                               float(m_r["potential_energy"]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s_2d.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-6)
    p_r = np.asarray(unpack_positions(s_ref.state, spec))
    p_2 = np.asarray(unpack_positions(s_2d.state, spec))
    np.testing.assert_allclose(p_2, p_r, rtol=1e-4, atol=1e-4)


@pytest.mark.smoke
def test_cli_spatial_devices_2d(tmp_path):
    """engine.spatial_devices: [2, 2] builds the 2-D engine from YAML and
    runs biased MD end-to-end."""
    import yaml as _yaml
    from metadyn_tpu.cli import build_sampler

    cfg = dict(
        system={"init": {"kind": "sc", "n_per_side": 6, "spacing": 2.0},
                "kT": 1.0},
        engine={"kind": "packed", "spatial_devices": [2, 2], "skin": 0.5,
                "rebuild_every": 5, "cap": 24,
                "pair": {"kind": "lj", "r_cut": 2.5, "shift": False}},
        integrator={"kind": "langevin", "dt": 0.004, "gamma": 1.0},
        cvs=[{"name": "lam", "kind": "lamellar",
              "lattice_vector": [0, 0, 2],
              "grid": {"min": -0.5, "max": 0.5, "num_points": 31,
                       "sigma": 0.02}}],
        metadynamics={"W": 0.3, "stride": 10, "mode": "well_tempered",
                      "deltaT": 5.0},
        run={"n_steps": 20, "report_every": 20},
        chunks_per_block=1, output={})
    sampler, _ = build_sampler(cfg)
    assert isinstance(sampler.engine, SpatialPackedEngine2D)
    h = sampler.run(20)
    assert np.isfinite(np.asarray(h[-1]["cv"])).all()
    assert not bool(h[-1]["nlist_overflow"])
    assert int(sampler.bias.n_hills) == 2

    # npt_scr + wte build on the 2-D mesh too (round 4)
    npt = dict(cfg)
    npt["integrator"] = {"kind": "npt_scr", "dt": 0.002, "gamma": 2.0,
                         "pressure": 1.0, "tau_p": 1.0}
    npt["cvs"] = [{"name": "u", "kind": "wte",
                   "grid": {"min": -4000.0, "max": 0.0, "num_points": 41,
                            "sigma": 100.0}}]
    s_npt, _ = build_sampler(npt)
    h_npt = s_npt.run(10)
    assert np.isfinite(np.asarray(h_npt[-1]["cv"])).all()
    L3 = np.asarray(s_npt.state.box.L)
    assert np.all(np.isfinite(L3)) and np.all(L3 > 0)

    # the mesh CV builds as the pencil-FFT ShardedPackedMesh2D (round 4)
    from metadyn_tpu.parallel.mesh2d import ShardedPackedMesh2D
    mk = dict(cfg)
    mk["cvs"] = [{"name": "sk", "kind": "mesh", "mesh": [8, 8, 8],
                  "k0": 1.57, "width": 0.5, "mode": [1.0],
                  "grid": {"min": 0.0, "max": 300.0, "num_points": 31,
                           "sigma": 15.0}}]
    s_mesh, _ = build_sampler(mk)
    assert isinstance(s_mesh.cvs[0], ShardedPackedMesh2D)
    h_mesh = s_mesh.run(10)
    assert np.isfinite(np.asarray(h_mesh[-1]["cv"])).all()

    # unsupported combos fail loudly before any compile
    bad = dict(cfg)
    bad["cvs"] = [{"name": "ar", "kind": "aspect_ratio",
                   "grid": {"min": 0.6, "max": 1.6, "num_points": 31,
                            "sigma": 0.03}}]
    with pytest.raises(ValueError, match="2-D decomposition"):
        build_sampler(bad)


@pytest.mark.smoke
def test_2d_npt_wte_matches_single_device():
    """SCR-NPT + the WTE energy CV on the 2-D (spacex, spacey) mesh: the
    2-D halo force already psum-reduces the interior-masked energy and
    per-axis virial every call, so the barostat and PotentialEnergyCV
    see live values — matches the single-device
    PackedEngine(with_energy=True) trajectory (cf. the 1-D twin,
    test_spatial.py::test_npt_wte_under_spatial_dd)."""
    from metadyn_tpu.integrate.packed import make_packed_npt_scr_step
    from metadyn_tpu.cv.simple import PotentialEnergyCV
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler
    from metadyn_tpu.utils.lattice import fcc_lattice

    kT, P = 1.2, 1.0
    a = 1.6
    pos = fcc_lattice(6, a)        # L = 9.6: 4 cells per axis on the 2x2
    n = pos.shape[0]
    L = 6 * a
    rng = np.random.default_rng(4)
    vel = rng.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.3, cap=24)

    def build(engine):
        state, ovf = engine.pack_state(
            pos, Box.cubic(L), jnp.zeros(n, jnp.int32), eps_i=jnp.ones(n),
            sigma_i=jnp.ones(n), vel=jnp.asarray(vel))
        assert not bool(ovf)
        return MetadSampler(
            make_system(n), state, engine, cvs=[PotentialEnergyCV()],
            grid_spec=GridSpec.create([-8000.0], [0.0], [81], [100.0]),
            hills=HillSpec.create(W=2.0, stride=25, mode=WELL_TEMPERED,
                                  deltaT=20.0),
            integrator_factory=lambda f: make_packed_npt_scr_step(
                f, spec, dt=0.002, kT=kT, pressure=P, gamma=2.0,
                tau_p=1.0),
            seed=0, chunks_per_block=2)

    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla",
                               with_energy=True))
    s_dd = build(SpatialPackedEngine2D(spec, _mesh2d(), rebuild_every=5))

    h_ref = s_ref.run(100)
    h_dd = s_dd.run(100)
    m_ref, m_dd = h_ref[-1], h_dd[-1]
    assert not bool(m_dd["nlist_overflow"])
    assert int(s_dd.bias.n_hills) == int(s_ref.bias.n_hills) == 4
    np.testing.assert_allclose(np.asarray(s_dd.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(s_dd.state.box.L),
                               np.asarray(s_ref.state.box.L), rtol=1e-4)
    assert abs(float(s_dd.state.box.L[0]) - L) > 1e-3
    p_ref = np.asarray(unpack_positions(s_ref.state, spec))
    p_dd = np.asarray(unpack_positions(s_dd.state, spec))
    np.testing.assert_allclose(p_dd, p_ref, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(float(m_dd["potential_energy"]),
                               float(m_ref["potential_energy"]), rtol=1e-4)


@pytest.mark.parametrize("order", [2, 3], ids=["cic", "tsc"])
def test_mesh_cv_pencil_fft(order):
    """The pencil-decomposed mesh FFT (parallel/mesh2d): ρ assigned
    locally per (x, y) block with two-hop halo-shell folds, pencil FFT
    with two all-to-all transposes — value, vjp forces, and k-space
    virial match the single-device PackedMesh, and the HLO proves the
    mesh is genuinely partitioned (pencil-shaped FFTs + two all-to-all
    collectives), for both assignment windows."""
    from metadyn_tpu.cv.packed import PackedMesh
    from metadyn_tpu.parallel.mesh2d import ShardedPackedMesh2D
    from metadyn_tpu.ops.packed import pack

    L = 4 * 3.0
    n = 1500
    rng = np.random.default_rng(11)
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    box = Box.cubic(L)
    system = make_system(n)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=40,
                             shift_energy=False)
    k0 = 2.0 * np.pi * 3 / L
    ref_cv = PackedMesh.create((32, 32, 32), L, n_real=n, k0=k0, width=0.5,
                               assign_order=order)
    amps = np.ones(n, np.float32)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n),
                   extra_attrs={ref_cv.attr_name: amps})
    assert not bool(ovf)
    # drift particles a little so the halo shells (incl. corners) carry
    disp = jnp.asarray(rng.uniform(-0.2, 0.2, (3, st.n_pad)), jnp.float32)
    st = st.replace(r=jnp.where((st.pid < n)[None, :], st.r + disp, st.r))

    dd_cv = ShardedPackedMesh2D.create((32, 32, 32), spec, _mesh2d(),
                                       n_real=n, k0=k0, width=0.5, box_L=L,
                                       assign_order=order)

    v_ref = float(ref_cv.value(st, system))
    val_fn = jax.jit(lambda s: dd_cv.value(s, system))
    v_dd = float(val_fn(st))
    np.testing.assert_allclose(v_dd, v_ref, rtol=2e-4)

    g_ref = jax.grad(lambda r: ref_cv.value(st.replace(r=r), system))(st.r)
    g_dd = jax.jit(jax.grad(
        lambda r: dd_cv.value(st.replace(r=r), system)))(st.r)
    np.testing.assert_allclose(np.asarray(g_dd), np.asarray(g_ref),
                               rtol=2e-2, atol=1e-5)

    w_ref = np.asarray(ref_cv.bias_virial(st, system, jnp.float32(1.3)))
    w_dd = np.asarray(jax.jit(
        lambda s: dd_cv.bias_virial(s, system, jnp.float32(1.3)))(st))
    np.testing.assert_allclose(w_dd, w_ref, rtol=2e-4, atol=1e-6)

    # sharding introspection: pencil-local FFT shapes (16x16x32 z-pencil,
    # not 32^3) and TWO all-to-all transposes
    hlo = val_fn.lower(st).as_text()
    assert hlo.count("all-to-all") >= 2 or hlo.count("all_to_all") >= 2
    assert "manual_computation" in hlo
    assert "16x16x32" in hlo, "FFT operates on the full mesh, not a pencil"


@pytest.mark.smoke
def test_walkers_times_2d_space():
    """Walkers x 2-D spatial-DD product mesh (round-4 VERDICT missing
    #1d): 2 walkers x (2, 2) sub-boxes on 8 CPU devices — the reference's
    ``mpirun -n W*nx*ny --nrank W`` with 2-D sub-boxes.  The WalkerSampler
    goes manual over "walkers"; the 2-D engine's nested halo islands
    manualize ("spacex", "spacey").  Matches the walkers-only run
    (f32 reduction-order noise), incl. the shared bias grid."""
    from metadyn_tpu.parallel.walkers import WalkerSampler
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED

    pos, _, n, box = _case()
    L = float(box.L[0])
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    cv = PackedLamellar.create([[0, 0, 2]], n_real=n, name="lam")
    amps = np.ones(n, np.float32)
    system = make_system(n)

    def pack_one(engine, w):
        r = np.random.default_rng(100 + w)
        vel = r.normal(0, 1.0, (n, 3)).astype(np.float32)
        vel -= vel.mean(axis=0)
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32), vel=vel,
            extra_attrs={cv.attr_name: amps})
        assert not bool(ovf)
        return st

    def build(engine, mesh):
        states = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[pack_one(engine, w) for w in range(2)])
        return WalkerSampler(
            system, states, engine, cvs=[cv],
            grid_spec=GridSpec.create([-0.5], [0.5], [51], [0.02]),
            hills=HillSpec.create(W=0.5, stride=25, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.001, kT=1.0, gamma=1.0),
            seed=0, chunks_per_block=1, mesh=mesh)

    devs = np.asarray(jax.devices())
    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla"),
                  Mesh(devs[:2], ("walkers",)))
    h_ref = s_ref.run(50)

    mesh3 = Mesh(devs[:8].reshape(2, 2, 2),
                 ("walkers", "spacex", "spacey"))
    s2 = build(SpatialPackedEngine2D(spec, mesh3, rebuild_every=5,
                                     nested=True), mesh3)
    h2 = s2.run(50)

    assert int(s2.bias.n_hills) == int(s_ref.bias.n_hills) == 4
    np.testing.assert_allclose(np.asarray(s2.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-6)
    m_ref, m2 = h_ref[-1], h2[-1]
    assert not np.any(np.asarray(m2["nlist_overflow"]))
    np.testing.assert_allclose(np.asarray(m2["cv"]),
                               np.asarray(m_ref["cv"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(m2["potential_energy"]),
                               np.asarray(m_ref["potential_energy"]),
                               rtol=1e-5)

    # keep running past half-skin triggers: the nested 2-D repack island
    # with the walker-joint rebuild decision stays conservative
    h3 = s2.run(150)
    m3 = h3[-1]
    assert not np.any(np.asarray(m3["nlist_overflow"]))
    assert np.isfinite(np.asarray(m3["potential_energy"])).all()
    assert int(s2.bias.n_hills) == 16


@pytest.mark.smoke
def test_flux_on_2d_and_walkers_2d_meshes():
    """Flux-tempered mode on the 2-D decomposition AND on the walkers x
    2-D product mesh from YAML (backs the §4.6 matrix row): pooled
    histograms, update applied, finite bias."""
    from metadyn_tpu.cli import build_sampler
    from metadyn_tpu.flux_sampler import FluxTemperedSampler

    base = dict(
        seed=0,
        system={"init": {"kind": "sc", "n_per_side": 6, "spacing": 2.0}},
        engine={"kind": "packed", "spatial_devices": [2, 2], "skin": 0.5,
                "rebuild_every": 2, "cap": 24,
                "pair": {"kind": "lj", "r_cut": 2.5, "shift": False}},
        integrator={"kind": "langevin", "dt": 0.004, "kT": 1.0,
                    "gamma": 1.0},
        cvs=[{"name": "lam", "kind": "lamellar",
              "lattice_vector": [0, 0, 2],
              "grid": {"min": -0.5, "max": 0.5, "num_points": 31,
                       "sigma": 0.02}}],
        metadynamics={"mode": "flux_tempered", "stride": 10,
                      "update_period": 2, "min_round_trips": 0},
        run={"n_steps": 20}, output={})
    s, _ = build_sampler(base)
    assert isinstance(s, FluxTemperedSampler)
    assert isinstance(s.engine, SpatialPackedEngine2D)
    s.run(20)
    assert s.n_updates == 1
    assert np.isfinite(np.asarray(s.bias.grid.V)).all()

    w2 = dict(base)
    w2["metadynamics"] = dict(base["metadynamics"], n_walkers=2)
    s2, _ = build_sampler(w2)
    assert s2.n_walkers == 2
    assert s2.mesh.axis_names == ("walkers", "spacex", "spacey")
    s2.run(20)
    assert tuple(s2.carry.flux.hist.shape) == (2, 31)
    assert s2.n_updates == 1
    assert np.isfinite(np.asarray(s2.bias.grid.V)).all()
