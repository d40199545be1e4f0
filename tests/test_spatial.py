"""Spatial domain decomposition tests (SURVEY.md §2b Communicator row):
the sharded cell-grid force with ppermute ghost planes must reproduce the
single-device packed force exactly, on the multi-device CPU mesh; the
mesh CV's FFT pipeline must give identical values under GSPMD sharding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from metadyn_tpu.core.box import Box
from metadyn_tpu.ops.packed import PackedSpec, pack, packed_lj_force
from metadyn_tpu.parallel.spatial import make_sharded_lj_force


def _liquid(n, L, seed):
    rng = np.random.default_rng(seed)
    # blue-noise-ish: jittered grid avoids catastrophic overlaps
    g = int(np.ceil(n ** (1 / 3)))
    pts = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)[:n]
    pos = (pts + rng.uniform(0.2, 0.8, (n, 3))) * (L / g) - L / 2
    return pos.astype(np.float32)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.smoke
def test_sharded_force_matches_single_device(n_dev):
    """2- and 4-device sharded forces == single-device forces, energy and
    virial to f32 exactness (the reference's DD ghost-exchange parity,
    SURVEY.md §4.5 fake-backend strategy)."""
    L = 8 * 3.0                      # cx = 8 divides 2 and 4
    n = 3000
    pos = _liquid(n, L, 0)
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    assert spec.cells_per_dim[0] % n_dev == 0
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n))
    assert not bool(ovf)

    ref = packed_lj_force(st, spec)

    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("space",))
    force = make_sharded_lj_force(spec, mesh)
    out = jax.jit(force)(st)

    np.testing.assert_allclose(np.asarray(out.f), np.asarray(ref.f),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(out.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out.virial), np.asarray(ref.virial),
                               rtol=1e-5)


@pytest.mark.smoke
def test_sharded_force_seam_pairs():
    """Adversarial: particles straddling the periodic x seam and every
    shard boundary must see their cross-boundary neighbors."""
    L = 8 * 3.0
    box = Box.cubic(L)
    # pairs at x boundaries: one particle each side, 1.0 apart
    xs = []
    for b in range(8):
        xb = -L / 2 + b * 3.0       # cell boundary position
        xs += [[xb - 0.5, 0.0, 0.0], [xb + 0.5, 0.0, 0.0]]
    pos = np.asarray(xs, np.float32)
    # spread y so pairs don't interact with each other
    pos[:, 1] = np.repeat(np.linspace(-L / 2 + 1, L / 2 - 1, 8), 2)
    n = pos.shape[0]
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=8,
                             shift_energy=False)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n))
    assert not bool(ovf)
    ref = packed_lj_force(st, spec)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("space",))
    out = jax.jit(make_sharded_lj_force(spec, mesh))(st)
    # every particle feels its partner (|F| > 0 for LJ at r=1)
    f_mag = np.linalg.norm(np.asarray(ref.f), axis=0)
    valid = np.asarray(st.pid) < n
    assert f_mag[valid].min() > 1.0
    np.testing.assert_allclose(np.asarray(out.f), np.asarray(ref.f),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(out.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.smoke
def test_sharded_repack_matches_single_device(n_dev):
    """The sharded migration (ghost-plane ownership handoff) produces a
    BIT-IDENTICAL slot assignment to the single-device incremental
    repack: same ranking order, same seam wrap arithmetic, same images
    (VERDICT r2 missing #1 — migration without a global repack)."""
    from metadyn_tpu.ops.packed import repack_incremental
    from metadyn_tpu.parallel.spatial import make_sharded_repack

    L = 8 * 3.0
    n = 3000
    pos = _liquid(n, L, 3)
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    rng = np.random.default_rng(7)
    vel = rng.normal(0, 1, (n, 3)).astype(np.float32)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n), vel=vel)
    assert not bool(ovf)
    # displace by up to ±1.0 (< one 3.0-wide cell): particles cross cell,
    # shard, and periodic-seam boundaries
    disp = jnp.asarray(rng.uniform(-1.0, 1.0, (3, st.n_pad)), jnp.float32)
    valid = (st.pid < n)[None, :]
    st = st.replace(r=jnp.where(valid, st.r + disp, st.r))

    ref, bad_ref = repack_incremental(st, spec)
    assert not bool(bad_ref)

    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("space",))
    out, bad = jax.jit(make_sharded_repack(spec, mesh))(st)
    assert not bool(bad)

    for name in ("r", "v", "f", "image", "pid", "typ", "slot_of"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)),
            err_msg=name)
    for k in ref.attrs:
        np.testing.assert_array_equal(np.asarray(out.attrs[k]),
                                      np.asarray(ref.attrs[k]), err_msg=k)


@pytest.mark.smoke
def test_sharded_biased_md_steps_match_single_device():
    """Full biased MD under the "space" axis — integrate + ghost
    exchange + migration + FENE bonds + CV reduction + WT hill deposit —
    matches the single-device MetadSampler trajectory (VERDICT r2
    missing #1: the reference's whole DD step loop, SURVEY.md §3.1)."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.ops.packed import bond_partner_attrs, unpack_positions
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler

    # dimer lattice: x-oriented LJ+FENE dimers on a grid — no overlaps,
    # some dimers straddle shard boundaries and the periodic seam
    L = 6 * 3.0
    g = 7
    sp = L / g
    sites = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * sp - L / 2 + 0.6
    rng = np.random.default_rng(0)
    sites = sites + rng.uniform(-0.1, 0.1, sites.shape)
    pos = np.concatenate([sites, sites + [0.97, 0.0, 0.0]])
    n = pos.shape[0]
    bonds = np.stack([np.arange(len(sites)),
                      np.arange(len(sites)) + len(sites)], axis=1)
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False, fene_k=30.0, fene_r0=1.5)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    amps = np.ones(n, np.float32)

    def build(engine):
        cv = PackedLamellar.create([[0, 0, 2]], n_real=n, name="lam")
        extra = {cv.attr_name: amps, **bond_partner_attrs(bonds, n)}
        state, ovf = engine.pack_state(
            pos, box, jnp.zeros(n, jnp.int32), eps_i=jnp.ones(n),
            sigma_i=jnp.ones(n), vel=jnp.asarray(vel), extra_attrs=extra)
        assert not bool(ovf)
        return MetadSampler(
            make_system(n), state, engine, cvs=[cv],
            grid_spec=GridSpec.create([-0.5], [0.5], [51], [0.02]),
            hills=HillSpec.create(W=0.5, stride=25, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.002, kT=1.0, gamma=1.0),
            seed=0, chunks_per_block=2)

    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla"))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
    s_dd = build(SpatialPackedEngine(spec, mesh, rebuild_every=5))

    h_ref = s_ref.run(100)
    h_dd = s_dd.run(100)
    m_ref, m_dd = h_ref[-1], h_dd[-1]
    assert not bool(m_dd["nlist_overflow"])
    # deposits happened and agree
    assert int(s_dd.bias.n_hills) == int(s_ref.bias.n_hills) == 4
    np.testing.assert_allclose(np.asarray(s_dd.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-5)
    # trajectories agree (f32 reduction-order noise only)
    p_ref = np.asarray(unpack_positions(s_ref.state, spec))
    p_dd = np.asarray(unpack_positions(s_dd.state, spec))
    np.testing.assert_allclose(p_dd, p_ref, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(float(m_dd["potential_energy"]),
                               float(m_ref["potential_energy"]), rtol=1e-4)


@pytest.mark.smoke
def test_sharded_force_with_bonds_matches():
    """Ghost planes carry pids + FENE partner attrs: cross-shard bonds
    get the bonded interaction, not the pair potential."""
    from metadyn_tpu.ops.packed import bond_partner_attrs

    L = 8 * 3.0
    g = 8
    sp_ = L / g
    sites = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * sp_ - L / 2 + 0.4
    pos = np.concatenate([sites, sites + [1.3, 0.0, 0.0]])
    n = pos.shape[0]
    bonds = np.stack([np.arange(len(sites)),
                      np.arange(len(sites)) + len(sites)], axis=1)
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False, fene_k=30.0, fene_r0=1.5)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n),
                   extra_attrs=bond_partner_attrs(bonds, n))
    assert not bool(ovf)
    ref = packed_lj_force(st, spec)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("space",))
    out = jax.jit(make_sharded_lj_force(spec, mesh))(st)
    np.testing.assert_allclose(np.asarray(out.f), np.asarray(ref.f),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(out.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out.virial), np.asarray(ref.virial),
                               rtol=1e-5)


@pytest.mark.smoke
@pytest.mark.parametrize("order", [2, 3], ids=["cic", "tsc"])
def test_mesh_cv_distributed_fft(order):
    """The TRUE distributed mesh FFT (VERDICT r2 missing #2): ρ assigned
    locally per x-slab with halo-column folds, slab FFT with an
    all-to-all transpose — value, vjp forces, and k-space virial match
    the single-device PackedMesh, and the HLO proves the mesh is
    genuinely partitioned (local-shape FFT + all-to-all collective), not
    replicated."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.cv.packed import PackedMesh
    from metadyn_tpu.parallel.mesh import ShardedPackedMesh

    L = 8 * 3.0
    n = 3000
    pos = _liquid(n, L, 11)
    box = Box.cubic(L)
    system = make_system(n)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    k0 = 2.0 * np.pi * 4 / L
    ref_cv = PackedMesh.create((32, 32, 32), L, n_real=n, k0=k0, width=0.5,
                               assign_order=order)
    amps = np.ones(n, np.float32)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n),
                   extra_attrs={ref_cv.attr_name: amps})
    assert not bool(ovf)
    # drift particles a little so halo columns are exercised
    rng = np.random.default_rng(5)
    disp = jnp.asarray(rng.uniform(-0.2, 0.2, (3, st.n_pad)), jnp.float32)
    st = st.replace(r=jnp.where((st.pid < n)[None, :], st.r + disp, st.r))

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("space",))
    dd_cv = ShardedPackedMesh.create((32, 32, 32), spec, mesh, n_real=n,
                                     k0=k0, width=0.5, box_L=L,
                                     assign_order=order)

    v_ref = float(ref_cv.value(st, system))
    val_fn = jax.jit(lambda s: dd_cv.value(s, system))
    v_dd = float(val_fn(st))
    np.testing.assert_allclose(v_dd, v_ref, rtol=2e-4)

    # vjp forces (the bias-force path) agree
    g_ref = jax.grad(lambda r: ref_cv.value(st.replace(r=r), system))(st.r)
    g_dd = jax.jit(jax.grad(
        lambda r: dd_cv.value(st.replace(r=r), system)))(st.r)
    np.testing.assert_allclose(np.asarray(g_dd), np.asarray(g_ref),
                               rtol=2e-2, atol=1e-5)

    # per-axis k-space virial agrees
    w_ref = np.asarray(ref_cv.bias_virial(st, system, jnp.float32(1.3)))
    w_dd = np.asarray(jax.jit(
        lambda s: dd_cv.bias_virial(s, system, jnp.float32(1.3)))(st))
    np.testing.assert_allclose(w_dd, w_ref, rtol=2e-4, atol=1e-6)

    # sharding introspection: the lowered HLO must contain the slab-local
    # FFT shape (4 x-columns of 32², not 32³) and the all-to-all transpose
    hlo = val_fn.lower(st).as_text()
    assert "all_to_all" in hlo
    assert "manual_computation" in hlo          # shard_map island present
    assert "4x32x32" in hlo, "FFT operates on the full mesh, not a slab"


@pytest.mark.smoke
def test_walkers_times_space_product_mesh():
    """Walkers x spatial-DD product mesh (the reference's
    ``mpirun -n W*S --nrank W``: W walker partitions, each internally
    domain-decomposed over S ranks — SURVEY.md §2b Communicator + MPI
    partitions rows).  2 walkers x 2 x-shards on 4 CPU devices: the
    WalkerSampler runs its stride chunk manual over "walkers" while the
    SpatialPackedEngine's nested halo islands go manual over "space".
    Phase 1 (no repack fires at dt=1e-3 over 50 steps): must reproduce
    the walkers-only run (PackedEngine on a 2-device mesh) — same keys,
    same physics — with the shared bias grid BITWISE identical.  Phase 2
    keeps running so the nested repack island and the walker-joint
    rebuild decision (see SpatialPackedEngine.rebuild: a repack cond
    diverging across walkers would deadlock the fused space collectives)
    are exercised; once repack TIMING couples walkers, trajectories are
    a different-but-equally-valid sample, so phase 2 asserts integrity,
    not equality."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.walkers import WalkerSampler
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED

    L = 6 * 3.0                      # cx = 6 cells: divisible by 2 shards
    g = 7
    sp = L / g
    sites = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * sp - L / 2 + 0.6
    rng = np.random.default_rng(0)
    pos = (sites + rng.uniform(-0.1, 0.1, sites.shape)).astype(np.float32)
    n = pos.shape[0]
    box = Box.cubic(L)
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

    mesh2 = Mesh(devs[:4].reshape(2, 2), ("walkers", "space"))
    s2 = build(SpatialPackedEngine(spec, mesh2, rebuild_every=5,
                                   nested=True), mesh2)
    h2 = s2.run(50)

    assert int(s2.bias.n_hills) == int(s_ref.bias.n_hills) == 4
    # hill deposits see space-psummed CVs: grids agree bitwise
    np.testing.assert_array_equal(np.asarray(s2.bias.grid.V),
                                  np.asarray(s_ref.bias.grid.V))
    m_ref, m2 = h_ref[-1], h2[-1]
    assert not np.any(np.asarray(m2["nlist_overflow"]))
    np.testing.assert_allclose(np.asarray(m2["cv"]),
                               np.asarray(m_ref["cv"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(m2["potential_energy"]),
                               np.asarray(m_ref["potential_energy"]),
                               rtol=1e-5)

    # phase 2: long enough that half-skin triggers fire — the nested
    # repack island runs with the walker-joint decision; particle count
    # stays conserved (overflow flag would trip otherwise)
    h3 = s2.run(150)
    m3 = h3[-1]
    assert not np.any(np.asarray(m3["nlist_overflow"]))
    assert np.isfinite(np.asarray(m3["potential_energy"])).all()
    assert np.isfinite(np.asarray(m3["cv"])).all()
    assert int(s2.bias.n_hills) == 16        # 8 strides x 2 walkers


@pytest.mark.smoke
def test_order_cvs_under_spatial_dd():
    """Steinhardt Q6 + coordination CVs under spatial DD: the packed
    order CVs are pure roll-sweep jnp, so GSPMD turns their cross-shard rolls into
    collectives — biased MD on the sharded engine must match the
    single-device run (SURVEY.md §2b Communicator row: 'the plugin's CVs
    allreduce partial sums' — ALL CVs, not just lamellar/mesh/msd)."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.sampler import MetadSampler
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed_order import (PackedSteinhardtQl,
                                             PackedCoordination)
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.utils.lattice import fcc_lattice

    a = 1.5874                       # fcc at rho=1.0: solid, Q6 ~ 0.57
    n_cells = 8
    pos = fcc_lattice(n_cells, a)
    n = pos.shape[0]                 # 2048
    L = n_cells * a                  # cx = 4: divisible by 2 shards
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=48,
                             shift_energy=False)
    nn = a / np.sqrt(2)
    rng = np.random.default_rng(3)
    vel = rng.normal(0, np.sqrt(0.3), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    system = make_system(n)

    def build(engine):
        q6 = PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6, name="q6")
        co = PackedCoordination(spec=spec, r0=nn * 1.35, name="co",
                                r_cut=nn * 1.35 * 1.5)
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32), vel=vel)
        assert not bool(ovf)
        return MetadSampler(
            system, st, engine, cvs=[q6, co],
            grid_spec=GridSpec.create([0.0, 4.0], [0.7, 16.0], [24, 24],
                                      [0.02, 0.5]),
            hills=HillSpec.create(W=0.3, stride=10, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.002, kT=0.3, gamma=1.0),
            seed=0, chunks_per_block=1)

    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla"))
    h_ref = s_ref.run(20)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
    s_dd = build(SpatialPackedEngine(spec, mesh, rebuild_every=5))
    h_dd = s_dd.run(20)

    m_ref, m_dd = h_ref[-1], h_dd[-1]
    # crystal Q6 in range, coordination ~ 12 first shell
    assert 0.4 < float(np.asarray(m_ref["cv"])[0]) < 0.65
    np.testing.assert_allclose(np.asarray(m_dd["cv"]),
                               np.asarray(m_ref["cv"]),
                               rtol=1e-4, atol=1e-5)
    assert int(s_dd.bias.n_hills) == int(s_ref.bias.n_hills) == 2
    np.testing.assert_allclose(np.asarray(s_dd.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(m_dd["potential_energy"]),
                               float(m_ref["potential_energy"]), rtol=1e-5)


@pytest.mark.slow
@pytest.mark.smoke
def test_product_mesh_trajectory_oracle_always_repack():
    """Trajectory-LEVEL oracle for the walkers×space product mesh
    (VERDICT r3 weak #5: phase 2 of the test above asserts integrity
    only).  Why equality is normally impossible: Langevin noise is drawn
    per SLOT, so repack TIMING changes which noise a particle receives,
    and the product mesh pmax-couples the repack decision across walkers.
    With ``always_repack=True`` (unconditional repack at every rebuild
    boundary — a strict superset of the distance-triggered repacks, so
    exactly as safe) the timing is deterministic and identical in both
    engines, and the nested-island long run must reproduce the
    walkers-only run through MANY repack/migration events."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.walkers import WalkerSampler
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED

    L = 6 * 3.0
    g = 7
    sp = L / g
    sites = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * sp - L / 2 + 0.6
    rng = np.random.default_rng(0)
    pos = (sites + rng.uniform(-0.1, 0.1, sites.shape)).astype(np.float32)
    n = pos.shape[0]
    box = Box.cubic(L)
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
                f, dt=0.004, kT=1.0, gamma=1.0),
            seed=0, chunks_per_block=1, mesh=mesh)

    devs = np.asarray(jax.devices())
    s_ref = build(
        PackedEngine(spec, rebuild_every=5, pair_path="xla",
                     always_repack=True),
        Mesh(devs[:2], ("walkers",)))
    h_ref = s_ref.run(150)     # 30 unconditional repacks, dt 4e-3

    mesh2 = Mesh(devs[:4].reshape(2, 2), ("walkers", "space"))
    s2 = build(SpatialPackedEngine(spec, mesh2, rebuild_every=5,
                                   nested=True, always_repack=True),
               mesh2)
    h2 = s2.run(150)

    m_ref, m2 = h_ref[-1], h2[-1]
    assert not np.any(np.asarray(m2["nlist_overflow"]))
    # grids f32-close (the sharded force reduces in a different order,
    # so CVs differ by ~1 ulp and hill centers shift microscopically);
    # trajectories f32-close through 30 migrations
    np.testing.assert_allclose(np.asarray(s2.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m2["cv"]),
                               np.asarray(m_ref["cv"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(m2["potential_energy"]),
                               np.asarray(m_ref["potential_energy"]),
                               rtol=1e-5)
    # per-particle endpoint comparison, walker 0
    p_ref = np.asarray(s_ref.states.r)[0]
    p_2 = np.asarray(s2.states.r)[0]
    pid_ref = np.asarray(s_ref.states.pid)[0]
    pid_2 = np.asarray(s2.states.pid)[0]
    # compare in particle order (slot layouts agree too, but don't rely)
    order_ref = np.argsort(pid_ref)[:n]
    order_2 = np.argsort(pid_2)[:n]
    np.testing.assert_allclose(p_2[:, order_2], p_ref[:, order_ref],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.smoke
def test_order_cvs_on_product_mesh():
    """Order CVs (Q6 + coordination) on the walkers x space product mesh:
    the roll-sweep CVs run inside the walkers-manual region with "space"
    left to GSPMD (exactly the space-only mechanism of
    test_order_cvs_under_spatial_dd) — the shared bias grid and the CV
    trajectories match the walkers-only run to f32 reduction-order noise
    (the per-shard partial sums reassociate the CV reductions, so unlike
    the lamellar product-mesh test this is allclose, not bitwise)."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.walkers import WalkerSampler
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed_order import (PackedSteinhardtQl,
                                             PackedCoordination)
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.utils.lattice import fcc_lattice

    a_lat = 1.62
    pos0 = fcc_lattice(8, a_lat)        # cx = 4 cells: divisible by 2
    n = pos0.shape[0]
    L = 8 * a_lat
    rng = np.random.default_rng(3)
    pos = (pos0 + rng.normal(0, 0.05, pos0.shape)).astype(np.float32)
    box = Box.cubic(L)
    system = make_system(n)
    nn = a_lat / np.sqrt(2)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=40,
                             shift_energy=False)
    grid = GridSpec.create([0.0, 4.0], [0.7, 28.0], [32, 32], [0.02, 0.5])

    def make_cvs():
        return [PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6,
                                   name="q6"),
                PackedCoordination(spec=spec, r0=nn * 1.35,
                                   r_cut=nn * 1.35 * 1.5, name="co")]

    def pack_one(engine, w):
        r = np.random.default_rng(100 + w)
        vel = r.normal(0, 1.0, (n, 3)).astype(np.float32)
        vel -= vel.mean(axis=0)
        st, ovf = engine.pack_state(pos, box, np.zeros(n, np.int32),
                                    eps_i=np.ones(n, np.float32),
                                    sigma_i=np.ones(n, np.float32), vel=vel)
        assert not bool(ovf)
        return st

    def build(engine, mesh):
        states = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[pack_one(engine, w) for w in range(2)])
        return WalkerSampler(
            system, states, engine, cvs=make_cvs(), grid_spec=grid,
            hills=HillSpec.create(W=0.4, stride=25, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.001, kT=0.7, gamma=1.0),
            seed=0, chunks_per_block=1, mesh=mesh)

    devs = np.asarray(jax.devices())
    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla"),
                  Mesh(devs[:2], ("walkers",)))
    h_ref = s_ref.run(50)
    mesh2 = Mesh(devs[:4].reshape(2, 2), ("walkers", "space"))
    s2 = build(SpatialPackedEngine(spec, mesh2, rebuild_every=5,
                                   nested=True), mesh2)
    h2 = s2.run(50)

    assert int(s2.bias.n_hills) == int(s_ref.bias.n_hills) == 4
    np.testing.assert_allclose(np.asarray(s2.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V), atol=2e-5)
    np.testing.assert_allclose(np.asarray(h2[-1]["cv"]),
                               np.asarray(h_ref[-1]["cv"]),
                               rtol=5e-4, atol=1e-5)
    assert not np.any(np.asarray(h2[-1]["nlist_overflow"]))


@pytest.mark.smoke
def test_npt_wte_under_spatial_dd():
    """SCR-NPT + the WTE energy CV under the "space" axis (round 4: the
    with_energy engine mode on the sharded engine — the XLA halo force's
    interior-masked energy/virial psum runs every step, so the barostat
    reads a live virial and PotentialEnergyCV a live energy).  Matches
    the single-device PackedEngine(with_energy=True) trajectory to f32
    reduction-order noise."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.ops.packed import unpack_positions
    from metadyn_tpu.integrate.packed import make_packed_npt_scr_step
    from metadyn_tpu.cv.simple import PotentialEnergyCV
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler
    from metadyn_tpu.utils.lattice import fcc_lattice

    kT, P = 1.2, 1.0
    a = 1.6
    pos = fcc_lattice(6, a)           # L = 9.6: cx = 4 cells over 2 shards
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
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
    s_dd = build(SpatialPackedEngine(spec, mesh, rebuild_every=5,
                                     with_energy=True))
    assert s_dd.engine.energy_live

    h_ref = s_ref.run(100)
    h_dd = s_dd.run(100)
    m_ref, m_dd = h_ref[-1], h_dd[-1]
    assert not bool(m_dd["nlist_overflow"])
    assert int(s_dd.bias.n_hills) == int(s_ref.bias.n_hills) == 4
    np.testing.assert_allclose(np.asarray(s_dd.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-4)
    # the box breathes, identically
    np.testing.assert_allclose(np.asarray(s_dd.state.box.L),
                               np.asarray(s_ref.state.box.L), rtol=1e-4)
    assert abs(float(s_dd.state.box.L[0]) - L) > 1e-3
    p_ref = np.asarray(unpack_positions(s_ref.state, spec))
    p_dd = np.asarray(unpack_positions(s_dd.state, spec))
    np.testing.assert_allclose(p_dd, p_ref, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(float(m_dd["potential_energy"]),
                               float(m_ref["potential_energy"]), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(m_dd["cv"]),
                               np.asarray(m_ref["cv"]), rtol=1e-4)


@pytest.mark.smoke
def test_mesh_cv_on_product_mesh():
    """S(k)/mesh CV on the walkers x space product mesh (round-4 VERDICT
    missing #1a): the slab-FFT island (parallel/mesh.ShardedPackedMesh)
    nests under the walker axis (``nested=True`` — only "space" goes
    manual inside the walkers-manual region), so the reference's
    ``mpirun -n W*S --nrank W`` workload with a distributed-FFT CV is
    expressible.  2 walkers x 2 shards vs the walkers-only run with the
    single-device PackedMesh: CV trajectories and the shared bias grid
    agree to FFT reassociation noise."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.mesh import ShardedPackedMesh
    from metadyn_tpu.parallel.walkers import WalkerSampler
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed import PackedMesh
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED

    L = 18.0                        # cx = 6 cells: divisible by 2 shards
    g = 7
    sp = L / g
    sites = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * sp - L / 2 + 0.6
    rng = np.random.default_rng(0)
    pos = (sites + rng.uniform(-0.1, 0.1, sites.shape)).astype(np.float32)
    n = pos.shape[0]
    box = Box.cubic(L)
    system = make_system(n)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    k0 = 2.0 * np.pi * 2 / L
    ref_cv = PackedMesh.create((8, 8, 8), L, n_real=n, k0=k0, width=0.5,
                               name="sk")
    amps = np.ones(n, np.float32)

    def pack_one(engine, w):
        r = np.random.default_rng(100 + w)
        vel = r.normal(0, 1.0, (n, 3)).astype(np.float32)
        vel -= vel.mean(axis=0)
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32), vel=vel,
            extra_attrs={ref_cv.attr_name: amps})
        assert not bool(ovf)
        return st

    # grid sized from the initial CV value (deposits must not clamp)
    eng0 = PackedEngine(spec, pair_path="xla")
    st0 = pack_one(eng0, 0)
    s0 = float(jax.jit(lambda s: ref_cv.value(s, system))(st0))
    hi = max(8.0 * s0, 10.0)
    grid = GridSpec.create([0.0], [hi], [41], [hi / 30])

    def build(engine, mesh, cv):
        states = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[pack_one(engine, w) for w in range(2)])
        return WalkerSampler(
            system, states, engine, cvs=[cv], grid_spec=grid,
            hills=HillSpec.create(W=0.5, stride=25, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.001, kT=1.0, gamma=1.0),
            seed=0, chunks_per_block=1, mesh=mesh)

    devs = np.asarray(jax.devices())
    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla"),
                  Mesh(devs[:2], ("walkers",)), ref_cv)
    h_ref = s_ref.run(50)

    mesh2 = Mesh(devs[:4].reshape(2, 2), ("walkers", "space"))
    dd_cv = ShardedPackedMesh.create((8, 8, 8), spec, mesh2, n_real=n,
                                     k0=k0, width=0.5, box_L=L, name="sk",
                                     nested=True)
    s2 = build(SpatialPackedEngine(spec, mesh2, rebuild_every=5,
                                   nested=True), mesh2, dd_cv)
    h2 = s2.run(50)

    assert int(s2.bias.n_hills) == int(s_ref.bias.n_hills) == 4
    np.testing.assert_allclose(np.asarray(h2[-1]["cv"]),
                               np.asarray(h_ref[-1]["cv"]),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s2.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-3, atol=1e-5)
    assert not np.any(np.asarray(h2[-1]["nlist_overflow"]))


@pytest.mark.smoke
def test_npt_wte_on_product_mesh():
    """SCR-NPT + the WTE energy CV on the walkers x space product mesh
    (round-4 VERDICT missing #1b): the nested XLA halo force psums the
    interior-masked energy and per-axis virial over "space" on EVERY
    call, so each walker's barostat and PotentialEnergyCV see live
    per-walker values.  Matches the walkers-only run with
    PackedEngine(with_energy=True)."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.walkers import WalkerSampler
    from metadyn_tpu.integrate.packed import make_packed_npt_scr_step
    from metadyn_tpu.cv.simple import PotentialEnergyCV
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.utils.lattice import fcc_lattice

    kT, P_ext = 1.2, 1.0
    a = 1.6
    pos = fcc_lattice(6, a)           # L = 9.6: cx = 4 cells over 2 shards
    n = pos.shape[0]
    L = 6 * a
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.3, cap=24)
    system = make_system(n)
    grid = GridSpec.create([-8000.0], [0.0], [81], [100.0])

    def pack_one(engine, w):
        r = np.random.default_rng(100 + w)
        vel = r.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
        vel -= vel.mean(axis=0)
        st, ovf = engine.pack_state(
            pos, Box.cubic(L), jnp.zeros(n, jnp.int32),
            eps_i=jnp.ones(n), sigma_i=jnp.ones(n), vel=jnp.asarray(vel))
        assert not bool(ovf)
        return st

    def build(engine, mesh):
        states = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[pack_one(engine, w) for w in range(2)])
        return WalkerSampler(
            system, states, engine, cvs=[PotentialEnergyCV()],
            grid_spec=grid,
            hills=HillSpec.create(W=2.0, stride=25, mode=WELL_TEMPERED,
                                  deltaT=20.0),
            integrator_factory=lambda f: make_packed_npt_scr_step(
                f, spec, dt=0.002, kT=kT, pressure=P_ext, gamma=2.0,
                tau_p=1.0),
            seed=0, chunks_per_block=1, mesh=mesh)

    devs = np.asarray(jax.devices())
    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla",
                               with_energy=True),
                  Mesh(devs[:2], ("walkers",)))
    h_ref = s_ref.run(100)
    mesh2 = Mesh(devs[:4].reshape(2, 2), ("walkers", "space"))
    s2 = build(SpatialPackedEngine(spec, mesh2, rebuild_every=5,
                                   nested=True, with_energy=True), mesh2)
    assert s2.engine.energy_live
    h2 = s2.run(100)

    m_ref, m2 = h_ref[-1], h2[-1]
    assert not np.any(np.asarray(m2["nlist_overflow"]))
    assert int(s2.bias.n_hills) == int(s_ref.bias.n_hills) == 8
    np.testing.assert_allclose(np.asarray(s2.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-4)
    # per-walker boxes breathe, identically to the walkers-only run
    L_ref = np.asarray(jax.device_get(s_ref.states.box.L))
    L_2 = np.asarray(jax.device_get(s2.states.box.L))
    np.testing.assert_allclose(L_2, L_ref, rtol=1e-4)
    assert np.all(np.abs(L_2[:, 0] - L) > 1e-3)
    np.testing.assert_allclose(np.asarray(m2["potential_energy"]),
                               np.asarray(m_ref["potential_energy"]),
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(m2["cv"]),
                               np.asarray(m_ref["cv"]), rtol=1e-4)


@pytest.mark.smoke
def test_box_metadynamics_under_spatial_dd():
    """Box-shape metadynamics (aspect-ratio CV + anisotropic SCR-NPT)
    under the 1-D spatial decomposition (round-4 VERDICT missing #3):
    ∂V/∂s couples to the box DOF through box_bias_fn inside the sharded
    chunk, against the psummed per-axis virial.  Matches the
    single-device PackedEngine(with_energy=True) trajectory — box
    lengths, bias grid, CV — to f32 reduction-order noise."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.integrate.packed import make_packed_npt_scr_step
    from metadyn_tpu.cv.aspect_ratio import AspectRatio, box_bias_fn_for
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler
    from metadyn_tpu.utils.lattice import fcc_lattice

    kT, P_ext = 1.0, 0.5
    a = 1.6
    pos = fcc_lattice(6, a)           # L = 9.6: cx = 4 cells over 2 shards
    n = pos.shape[0]
    L = 6 * a
    rng = np.random.default_rng(5)
    vel = rng.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.3, cap=24)
    cv = AspectRatio()

    def factory(f, bias, engine=None):
        return make_packed_npt_scr_step(
            f, spec, dt=0.002, kT=kT, pressure=P_ext, gamma=2.0,
            tau_p=1.0, anisotropic=True,
            box_bias_fn=box_bias_fn_for(cv, bias))

    def build(engine):
        state, ovf = engine.pack_state(
            pos, Box.cubic(L), jnp.zeros(n, jnp.int32), eps_i=jnp.ones(n),
            sigma_i=jnp.ones(n), vel=jnp.asarray(vel))
        assert not bool(ovf)
        return MetadSampler(
            make_system(n), state, engine, cvs=[cv],
            grid_spec=GridSpec.create([0.6], [1.6], [41], [0.03]),
            hills=HillSpec.create(W=0.3, stride=25, mode=WELL_TEMPERED,
                                  deltaT=4.0),
            integrator_factory=factory, seed=0, chunks_per_block=2)

    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla",
                               with_energy=True))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
    s_dd = build(SpatialPackedEngine(spec, mesh, rebuild_every=5,
                                     with_energy=True))

    h_ref = s_ref.run(100)
    h_dd = s_dd.run(100)
    m_ref, m_dd = h_ref[-1], h_dd[-1]
    assert not bool(m_dd["nlist_overflow"])
    assert int(s_dd.bias.n_hills) == int(s_ref.bias.n_hills) == 4
    np.testing.assert_allclose(np.asarray(s_dd.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-4)
    L_ref = np.asarray(s_ref.state.box.L)
    L_dd = np.asarray(s_dd.state.box.L)
    np.testing.assert_allclose(L_dd, L_ref, rtol=1e-4)
    # anisotropic barostat: the box actually changed shape
    assert abs(float(L_dd[0] / L_dd[1]) - 1.0) > 1e-4 \
        or abs(float(L_dd[0]) - L) > 1e-3
    np.testing.assert_allclose(np.asarray(m_dd["cv"]),
                               np.asarray(m_ref["cv"]), rtol=1e-4)


@pytest.mark.smoke
def test_triclinic_under_spatial_dd():
    """TRICLINIC boxes under the 1-D spatial decomposition (round 5 —
    the last DD exclusion the reference does not have: HOOMD runs tilted
    cells under its MPI decomposition).  The slab axis is FRACTIONAL x,
    whose lattice vector a1 = h·(1,0,0) = (Lx, 0, 0) under the HOOMD
    upper-triangular h — so the ghost seam shift stays a pure ±Lx
    x-shift, while binning/wraps go fractional and the in-kernel roll
    shifts are h-matrix lattice vectors.  Three oracles on a 2-shard
    mesh vs the single-device triclinic packed engine: (1) forces +
    energy + virial, (2) bit-identical migration through seam/corner
    handoffs, (3) a 100-step biased-MD trajectory (lamellar CV with
    reciprocal-lattice k, WT deposits)."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.ops.packed import repack_incremental, unpack_positions
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler

    L, tilt = 15.0, (0.2, -0.15, 0.1)
    rng = np.random.default_rng(0)
    box = Box.triclinic(L, L, L, *tilt)
    # non-overlapping init: jittered sc lattice in FRACTIONAL space,
    # mapped through h (a random-uniform fill has LJ near-contacts that
    # detonate the MD phase)
    from metadyn_tpu.core.box import h_matrix
    g = 9
    f = (np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                  -1).reshape(-1, 3) + 0.5) / g - 0.5
    f = f + rng.uniform(-0.03, 0.03, f.shape)
    pos = (np.asarray(h_matrix(box)) @ f.T).T.astype(np.float32)
    n = pos.shape[0]
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    system = make_system(n)
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.4, cap=16,
                             shift_energy=False, tilt=tilt)
    assert spec.cells_per_dim[0] % 2 == 0
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))

    def packed_state(engine):
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32), vel=vel)
        assert not bool(ovf)
        return st

    eng_ref = PackedEngine(spec, rebuild_every=5, pair_path="xla")
    eng_dd = SpatialPackedEngine(spec, mesh, rebuild_every=5)

    # (1) force/energy/virial parity in the tilted cell
    st_ref = packed_state(eng_ref)
    st_dd = packed_state(eng_dd)
    out_ref = jax.jit(lambda s: eng_ref.force_into(s, None))(st_ref)
    out_dd = jax.jit(lambda s: eng_dd.force_into(s, None))(st_dd)
    scale = float(jnp.abs(out_ref.f).max())
    np.testing.assert_allclose(np.asarray(out_dd.f), np.asarray(out_ref.f),
                               rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(float(out_dd.potential_energy),
                               float(out_ref.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out_dd.virial),
                               np.asarray(out_ref.virial), rtol=1e-4)

    # (2) migration bit-identity through tilted seam handoffs
    dr = jnp.asarray(rng.uniform(-1.2, 1.2, (3, st_ref.r.shape[1])),
                     jnp.float32)
    pushed = st_ref.replace(r=st_ref.r + dr)
    ref, bad_r = jax.jit(lambda s: repack_incremental(s, spec))(pushed)
    got, bad_d = jax.jit(eng_dd._sharded_repack)(pushed)
    assert not bool(bad_r) and not bool(bad_d)
    np.testing.assert_array_equal(np.asarray(got.pid), np.asarray(ref.pid))
    np.testing.assert_allclose(np.asarray(got.r), np.asarray(ref.r),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.image),
                                  np.asarray(ref.image))

    # (3) biased-MD trajectory differential (lamellar CV uses the
    # reciprocal-lattice k of the tilted cell)
    cv = PackedLamellar.create([[0, 0, 2]], n_real=n, name="lam")

    def build(engine):
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32), vel=vel,
            extra_attrs={cv.attr_name: np.ones(n, np.float32)})
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
    s_dd = build(SpatialPackedEngine(spec, mesh, rebuild_every=5))
    h_dd = s_dd.run(100)
    m_r, m_d = h_ref[-1], h_dd[-1]
    assert not bool(m_r["nlist_overflow"]) and not bool(m_d["nlist_overflow"])
    np.testing.assert_allclose(np.asarray(m_d["cv"]),
                               np.asarray(m_r["cv"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_dd.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-6)
    p_r = np.asarray(unpack_positions(s_ref.state, spec))
    p_d = np.asarray(unpack_positions(s_dd.state, spec))
    np.testing.assert_allclose(p_d, p_r, rtol=1e-4, atol=1e-4)


@pytest.mark.smoke
def test_triclinic_on_product_mesh():
    """Triclinic boxes compose with walkers x space too (the docs §4.6
    matrix claim): the tilt operand rides the nested islands as a
    walker-varying replicated-over-space input.  2 walkers x 2 shards in
    the tilted cell match the walkers-only run."""
    from metadyn_tpu.core.box import h_matrix
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.walkers import WalkerSampler
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.cv.packed import PackedLamellar
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED

    L, tilt = 15.0, (0.2, -0.15, 0.1)
    rng = np.random.default_rng(0)
    box = Box.triclinic(L, L, L, *tilt)
    g = 9
    f = (np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                  -1).reshape(-1, 3) + 0.5) / g - 0.5
    f = f + rng.uniform(-0.03, 0.03, f.shape)
    pos = (np.asarray(h_matrix(box)) @ f.T).T.astype(np.float32)
    n = pos.shape[0]
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.4, cap=16,
                             shift_energy=False, tilt=tilt)
    cv = PackedLamellar.create([[0, 0, 2]], n_real=n, name="lam")
    system = make_system(n)

    def pack_one(engine, w):
        r = np.random.default_rng(100 + w)
        vel = r.normal(0, 1.0, (n, 3)).astype(np.float32)
        vel -= vel.mean(0)
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32), vel=vel,
            extra_attrs={cv.attr_name: np.ones(n, np.float32)})
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
            integrator_factory=lambda f2: make_packed_langevin_step(
                f2, dt=0.002, kT=1.0, gamma=1.0),
            seed=0, chunks_per_block=1, mesh=mesh)

    devs = np.asarray(jax.devices())
    s_ref = build(PackedEngine(spec, rebuild_every=5, pair_path="xla"),
                  Mesh(devs[:2], ("walkers",)))
    h_ref = s_ref.run(50)
    mesh2 = Mesh(devs[:4].reshape(2, 2), ("walkers", "space"))
    s2 = build(SpatialPackedEngine(spec, mesh2, rebuild_every=5,
                                   nested=True), mesh2)
    h2 = s2.run(50)
    np.testing.assert_allclose(np.asarray(h2[-1]["cv"]),
                               np.asarray(h_ref[-1]["cv"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s2.bias.grid.V),
                               np.asarray(s_ref.bias.grid.V),
                               rtol=1e-4, atol=1e-6)
    assert not np.any(np.asarray(h2[-1]["nlist_overflow"]))
