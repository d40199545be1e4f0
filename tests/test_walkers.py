"""Multi-walker metadynamics on the 8-virtual-device CPU mesh
(SURVEY.md §4.5 — the same shard_map/psum code runs on several GPUs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metadyn_tpu.core.box import Box
from metadyn_tpu.core.state import make_state, make_system
from metadyn_tpu.core.forcefield import ForceField
from metadyn_tpu.integrate.langevin import make_langevin_step
from metadyn_tpu.cv.simple import AxisPosition
from metadyn_tpu.bias.grid import GridSpec
from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED, BiasState, deposit
from metadyn_tpu.parallel.walkers import WalkerSampler
from metadyn_tpu.sampler import MetadSampler


A_WELL = 2.0


def _dw(pos, state, system):
    x = pos[0, 0]
    return A_WELL * (x * x - 1.0) ** 2 + 5.0 * (pos[0, 1] ** 2 + pos[0, 2] ** 2)


def _make_walker_sampler(n_steps_equiv=None, seed=0, stride=25):
    assert jax.device_count() == 8, "conftest must provide 8 virtual devices"
    system = make_system(1)
    ff = ForceField(external=_dw)
    box = Box.cubic(50.0)
    # 8 walkers: half start in each well
    starts = np.asarray([[1.0 - 2.0 * (w % 2), 0, 0] for w in range(8)],
                        np.float32)
    states = jax.vmap(lambda p: make_state(p[None, :], box))(jnp.asarray(starts))
    hills = HillSpec.create(W=0.1, stride=stride, mode=WELL_TEMPERED, deltaT=6.0)
    grid = GridSpec.create([-1.6], [1.6], [161], [0.1])
    return WalkerSampler(
        system, states, ff.bind(system), cvs=[AxisPosition(0, 0, name="x")],
        grid_spec=grid, hills=hills,
        integrator_factory=lambda f: make_langevin_step(
            f, system, dt=0.005, kT=0.6, gamma=5.0),
        seed=seed,
    )


@pytest.mark.smoke
def test_walkers_share_grid():
    s = _make_walker_sampler()
    out = s.run(250)  # 10 strides × 8 walkers
    assert int(s.bias.n_hills) == 80
    V = np.asarray(s.bias.grid.V)
    assert np.all(np.isfinite(V)) and V.max() > 0.3
    # walkers started in both wells → bias grows on both sides early
    x = np.asarray(s.grid_spec.axis_coords(0))
    left = V[np.abs(x + 1.0) < 0.3].max()
    right = V[np.abs(x - 1.0) < 0.3].max()
    assert left > 0.2 and right > 0.2, (left, right)
    m = out[-1]
    assert np.asarray(m["cv"]).shape == (8, 1)
    assert np.all(np.isfinite(np.asarray(m["temperature"])))


def test_walker_grid_matches_serial_deposits():
    """One shard_map stride with W walkers == W sequential standard-mode
    deposits at the same centers (allreduce-delta semantics)."""
    s = _make_walker_sampler(stride=25)
    hills_std = HillSpec.create(W=0.1, stride=25)  # standard: height const
    s.hills = hills_std
    # rebuild the chunk with standard mode: easiest is a fresh sampler
    system = make_system(1)
    ff = ForceField(external=_dw)
    box = Box.cubic(50.0)
    starts = np.asarray([[1.0 - 2.0 * (w % 2), 0, 0] for w in range(8)],
                        np.float32)
    states = jax.vmap(lambda p: make_state(p[None, :], box))(jnp.asarray(starts))
    ws = WalkerSampler(
        system, states, ff.bind(system), cvs=[AxisPosition(0, 0, name="x")],
        grid_spec=GridSpec.create([-1.6], [1.6], [161], [0.1]), hills=hills_std,
        integrator_factory=lambda f: make_langevin_step(
            f, system, dt=0.005, kT=0.6, gamma=5.0),
        seed=3,
    )
    out = ws.run(25)
    centers = np.asarray(out[-1]["cv"]).reshape(8, 1)
    # serial reference: deposit the same 8 hills on an empty grid
    ref = BiasState.zeros(ws.grid_spec)
    for c in centers:
        ref, _ = deposit(hills_std, ref, jnp.asarray(c), jnp.int32(0))
    np.testing.assert_allclose(np.asarray(ws.bias.grid.V),
                               np.asarray(ref.grid.V), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ws.bias.grid.dV),
                               np.asarray(ref.grid.dV), rtol=1e-4, atol=1e-5)


def test_walkers_converge_faster_fes(tmp_path):
    """8 walkers reach a usable double-well FES in few wall-clock steps
    (time-averaged WT estimator — the instantaneous one oscillates)."""
    from metadyn_tpu.bias.metad import free_energy
    s = _make_walker_sampler()
    s.run(10_000)  # transient (×8 walkers of hill flux)
    x = np.asarray(s.grid_spec.axis_coords(0))
    F_acc = np.zeros_like(x)
    n_seg = 8
    for _ in range(n_seg):
        s.run(5_000)
        F_acc += np.asarray(free_energy(s.hills, s.bias, jnp.float32(0.6)))
    F = F_acc / n_seg
    F_true = A_WELL * (x ** 2 - 1.0) ** 2
    m = np.abs(x) <= 1.1
    err = (F - F_true)[m]
    err -= err.mean()
    assert np.max(np.abs(err)) < 0.3, np.max(np.abs(err))


def test_walker_hill_log_and_checkpoint(tmp_path):
    """WalkerSampler parity with MetadSampler (VERDICT r1 item 8): hill
    log rows per (stride, walker), grid dump, and bitwise kill-and-resume
    through the checkpoint."""
    from metadyn_tpu.io.hill_log import read_hills
    from metadyn_tpu.io.grid_file import load_grid

    hill_path = str(tmp_path / "walker_hills.dat")
    system = make_system(1)
    ff = ForceField(external=_dw)
    box = Box.cubic(50.0)
    starts = np.asarray([[1.0 - 2.0 * (w % 2), 0, 0] for w in range(8)],
                        np.float32)

    def mk(hf=None):
        states = jax.vmap(lambda p: make_state(p[None, :], box))(
            jnp.asarray(starts))
        return WalkerSampler(
            system, states, ff.bind(system),
            cvs=[AxisPosition(0, 0, name="x")],
            grid_spec=GridSpec.create([-1.6], [1.6], [161], [0.1]),
            hills=HillSpec.create(W=0.1, stride=25, mode=WELL_TEMPERED,
                                  deltaT=6.0),
            integrator_factory=lambda f: make_langevin_step(
                f, system, dt=0.005, kT=0.6, gamma=5.0),
            seed=0, hill_file=hf, overwrite=True)

    s1 = mk(hf=hill_path)
    s1.run(100)  # 4 strides
    h = read_hills(hill_path)
    assert h["step"].shape[0] == 4 * 8  # one row per (stride, walker)
    assert set(h["step"]) == {25, 50, 75, 100}
    assert np.all(np.abs(h["center"]) < 1.6)

    ckpt = str(tmp_path / "walkers.npz")
    s1.save_checkpoint(ckpt)
    s1.dump_grid(str(tmp_path / "walker_grid.npz"))
    gbias, meta = load_grid(str(tmp_path / "walker_grid.npz"))
    np.testing.assert_array_equal(np.asarray(gbias.grid.V),
                                  np.asarray(s1.bias.grid.V))
    s1.run(100)
    V_ref = np.asarray(s1.bias.grid.V)

    s2 = mk()
    s2.load_checkpoint(ckpt)
    s2.run(100)
    np.testing.assert_array_equal(V_ref, np.asarray(s2.bias.grid.V))


@pytest.mark.smoke
def test_walkers_with_packed_engine():
    """Multi-walker metadynamics over a REAL packed LJ system: 8 walkers
    x 864 particles on the CPU mesh, shared grid, lamellar CV (VERDICT r1
    item 8 'one multi-walker run of a REAL packed system')."""
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.ops.packed import PackedSpec
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.utils.lattice import fcc_lattice

    rho = 0.8
    a = (4.0 / rho) ** (1.0 / 3.0)
    pos = fcc_lattice(6, a)          # 864 particles
    n = pos.shape[0]
    L = 6 * a
    box = Box.cubic(L)
    kT = 1.0
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=40,
                             shift_energy=False)
    engine = PackedEngine(spec, rebuild_every=5, pair_path="xla")
    system = make_system(n)
    cv = PackedLamellar.create([[0, 0, 2]], n_real=n, name="a")
    amps = np.ones(n, np.float32)

    def pack_one(w):
        rng = np.random.default_rng(w)
        vel = rng.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
        st, ovf = engine.pack_state(
            pos, box, jnp.zeros(n, jnp.int32), eps_i=jnp.ones(n),
            sigma_i=jnp.ones(n), vel=vel,
            extra_attrs={cv.attr_name: amps})
        assert not bool(ovf)
        return st

    states = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[pack_one(w) for w in range(8)])
    ws = WalkerSampler(
        system, states, engine, cvs=[cv],
        grid_spec=GridSpec.create([-0.2], [0.2], [41], [0.01]),
        hills=HillSpec.create(W=0.05, stride=20, mode=WELL_TEMPERED,
                              deltaT=5.0),
        integrator_factory=lambda f: make_packed_langevin_step(
            f, dt=0.005, kT=kT, gamma=1.0),
        seed=0, chunks_per_block=2)
    out = ws.run(80)  # 4 strides x 8 walkers
    assert int(ws.bias.n_hills) == 32
    m = out[-1]
    assert np.asarray(m["cv"]).shape == (8, 1)
    assert np.all(np.isfinite(np.asarray(m["potential_energy"])))
    assert not np.any(np.asarray(m["nlist_overflow"]))
    V = np.asarray(ws.bias.grid.V)
    assert np.isfinite(V).all() and V.max() > 0.0


@pytest.mark.smoke
def test_walker_measurement_histogram(tmp_path):
    """measure_cv_hist: the on-device per-step CV visit histogram counts
    every (step, walker) exactly once, the reweighted free_energy is
    finite, and the measurement accumulators survive checkpoint/resume.
    (Also pins the shard_map varying-axis fix: the histogram carry enters
    the scan pcast-varying over the walker axis.)"""
    system = make_system(1)
    ff = ForceField(external=_dw)
    box = Box.cubic(50.0)
    starts = np.asarray([[1.0 - 2.0 * (w % 2), 0, 0] for w in range(8)],
                        np.float32)

    def mk():
        states = jax.vmap(lambda p: make_state(p[None, :], box))(
            jnp.asarray(starts))
        return WalkerSampler(
            system, states, ff.bind(system),
            cvs=[AxisPosition(0, 0, name="x")],
            grid_spec=GridSpec.create([-1.6], [1.6], [161], [0.1]),
            hills=HillSpec.create(W=0.1, stride=25, mode=WELL_TEMPERED,
                                  deltaT=6.0),
            integrator_factory=lambda f: make_langevin_step(
                f, system, dt=0.005, kT=0.6, gamma=5.0),
            seed=0, measure_cv_hist=True)

    s = mk()
    s.run(50)                       # pre-measurement strides don't count
    s.begin_measurement()
    s.run(100)
    assert s._meas_h.sum() == 100 * 8   # every (step, walker) binned once
    F = s.free_energy(0.6)
    assert np.all(np.isfinite(F)) and F.min() == 0.0
    # visited region (walkers sit in the wells) dominates the histogram
    x = np.asarray(s.grid_spec.axis_coords(0))
    assert s._meas_h[np.abs(np.abs(x) - 1.0) < 0.35].sum() > 0.5 * 800

    ckpt = str(tmp_path / "meas.npz")
    s.save_checkpoint(ckpt)
    s.run(50)
    ref_h, ref_V, ref_n = s._meas_h.copy(), s._meas_V.copy(), s._meas_n
    s2 = mk()
    s2.load_checkpoint(ckpt)
    assert s2._meas_n == 4           # 4 strides measured pre-checkpoint
    s2.run(50)
    np.testing.assert_array_equal(s2._meas_h, ref_h)
    np.testing.assert_allclose(s2._meas_V, ref_V, rtol=1e-6)
    assert s2._meas_n == ref_n


@pytest.mark.smoke
def test_walkers_fes_tenth_kt_oracle():
    """8-walker WT FES hits the ≤0.1 kT north-star tolerance
    (BASELINE.md): measured 0.063 kT with this protocol — the walker
    hill flux (8× serial) converges the double well in ~15 s."""
    from metadyn_tpu.bias.metad import free_energy
    s = _make_walker_sampler()
    kT = 0.6
    x = np.asarray(s.grid_spec.axis_coords(0))
    F_true = A_WELL * (x ** 2 - 1.0) ** 2
    s.run(50_000)
    F_acc = np.zeros_like(x)
    n_seg = 12
    for _ in range(n_seg):
        s.run(25_000)
        F_acc += np.asarray(free_energy(s.hills, s.bias, jnp.float32(kT)))
    F = F_acc / n_seg
    m = np.abs(x) <= 1.1
    err = (F - F_true)[m]
    err -= err.mean()
    assert np.max(np.abs(err)) < 0.1 * kT, np.max(np.abs(err)) / kT


def test_walkers_add_hills_false_frozen_bias():
    """``add_hills=False`` on the walker sampler: all 8 replicas sample
    under the same static grid — no deposits, no allreduce, grid bitwise
    unchanged (reference frozen-bias multiple-walker production run)."""
    s1 = _make_walker_sampler()
    s1.run(100)
    seeded = s1.bias
    assert int(seeded.n_hills) == 32

    system = make_system(1)
    ff = ForceField(external=_dw)
    box = Box.cubic(50.0)
    starts = np.asarray([[1.0 - 2.0 * (w % 2), 0, 0] for w in range(8)],
                        np.float32)
    states = jax.vmap(lambda p: make_state(p[None, :], box))(
        jnp.asarray(starts))
    s2 = WalkerSampler(
        system, states, ff.bind(system), cvs=[AxisPosition(0, 0, name="x")],
        grid_spec=s1.grid_spec,
        hills=HillSpec.create(W=0.1, stride=25, mode=WELL_TEMPERED,
                              deltaT=6.0),
        integrator_factory=lambda f: make_langevin_step(
            f, system, dt=0.005, kT=0.6, gamma=5.0),
        seed=5, initial_bias=seeded, add_hills=False,
    )
    out = s2.run(100)
    assert np.array_equal(np.asarray(s2.bias.grid.V),
                          np.asarray(seeded.grid.V))
    assert int(s2.bias.n_hills) == int(seeded.n_hills)
    assert all(float(np.max(np.abs(m["hill_height"]))) == 0.0 for m in out)


@pytest.mark.smoke
def test_walker_bias_every_mts():
    """bias_every > 1 in MULTI-WALKER mode (round-4 VERDICT missing #1c):
    the per-walker CV sweep + ∂V/∂s run once per bias_every steps with
    the bias force held in between — walker-LOCAL, composing orthogonally
    with the stride-tail hill psum.  At small dt the MTS run tracks the
    exact-cadence run closely; the subsampled visit histogram keeps the
    per-(step, walker) normalization."""
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.ops.packed import PackedSpec
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.utils.lattice import fcc_lattice

    a = 1.7
    pos = fcc_lattice(6, a)
    n = pos.shape[0]
    L = 6 * a
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=40,
                             shift_energy=False)
    system = make_system(n)
    cv = PackedLamellar.create([[0, 0, 2]], n_real=n, name="a")
    amps = np.ones(n, np.float32)

    def build(bias_every):
        engine = PackedEngine(spec, rebuild_every=5, pair_path="xla")

        def pack_one(w):
            rng = np.random.default_rng(w)
            vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
            vel -= vel.mean(axis=0)
            st, ovf = engine.pack_state(
                pos, box, jnp.zeros(n, jnp.int32), eps_i=jnp.ones(n),
                sigma_i=jnp.ones(n), vel=vel,
                extra_attrs={cv.attr_name: amps})
            assert not bool(ovf)
            return st

        states = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[pack_one(w) for w in range(2)])
        return WalkerSampler(
            system, states, engine, cvs=[cv],
            grid_spec=GridSpec.create([-0.3], [0.3], [41], [0.01]),
            hills=HillSpec.create(W=0.1, stride=25, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.001, kT=1.0, gamma=1.0),
            seed=0, chunks_per_block=1, measure_cv_hist=True,
            mesh=jax.sharding.Mesh(np.asarray(jax.devices()[:2]),
                                   ("walkers",)),
            bias_every=bias_every)

    s1 = build(1)
    s1.begin_measurement()
    h1 = s1.run(50)
    s5 = build(5)
    s5.begin_measurement()
    h5 = s5.run(50)

    assert int(s5.bias.n_hills) == int(s1.bias.n_hills) == 4
    # subsampled histogram preserves the per-(step, walker) total
    assert float(s5._meas_h.sum()) == float(s1._meas_h.sum()) == 2 * 50
    # at dt=1e-3 over 50 steps the held-force approximation is tiny
    np.testing.assert_allclose(np.asarray(h5[-1]["cv"]),
                               np.asarray(h1[-1]["cv"]),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s5.bias.grid.V),
                               np.asarray(s1.bias.grid.V),
                               rtol=1e-3, atol=1e-5)
