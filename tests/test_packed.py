"""Packed cell-engine tests: 27-offset roll force vs all-pairs oracle,
pack/repack slot bookkeeping, and the Triton pair kernel in interpret
mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metadyn_tpu.core.box import Box
from metadyn_tpu.ops.packed import (
    PackedSpec, pack, repack, packed_lj_force, needs_repack,
    unpack_positions, packed_temperature,
)
from metadyn_tpu.ops.pairs import lj_tables, lj_kernel, all_pairs_force
from metadyn_tpu.utils.lattice import fcc_lattice
from metadyn_tpu.integrate.packed import make_packed_langevin_step
from metadyn_tpu.ops.packed_triton import packed_lj_force_triton


def _kernel(st, spec, **kw):
    """The Triton pair kernel through the Pallas interpreter."""
    return packed_lj_force_triton(st, spec, interpret=True, **kw)


def _fcc_case(ncell=6, a=1.7, r_cut=2.5):
    pos = fcc_lattice(ncell, a)
    n = pos.shape[0]
    L = ncell * a
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=r_cut, skin=0.5)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n))
    return pos, n, box, spec, st, ovf


def test_pack_roundtrip():
    pos, n, box, spec, st, ovf = _fcc_case()
    assert not bool(ovf)
    assert int((st.pid < n).sum()) == n
    np.testing.assert_allclose(unpack_positions(st, spec), pos, atol=1e-6)


@pytest.mark.smoke
def test_packed_force_matches_all_pairs():
    pos, n, box, spec, st, ovf = _fcc_case()
    st = packed_lj_force(st, spec)
    ref = all_pairs_force(jnp.asarray(pos), jnp.zeros(n, jnp.int32), box,
                          lj_kernel, lj_tables(1, r_cut=2.5), row_block=216)
    f_p = np.asarray(st.f[:, st.slot_of].T)
    np.testing.assert_allclose(float(st.potential_energy), float(ref.energy),
                               rtol=1e-4)
    np.testing.assert_allclose(f_p, np.asarray(ref.force), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(st.virial), np.asarray(ref.virial), rtol=1e-4)


@pytest.mark.smoke
def test_packed_force_random_config():
    rng = np.random.default_rng(0)
    n, L = 400, 12.0
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    box = Box.cubic(L)
    # random (Poisson) occupancy has fat tails — give explicit headroom
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.4, cap=16)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n))
    assert not bool(ovf)
    st = packed_lj_force(st, spec)
    ref = all_pairs_force(jnp.asarray(pos), jnp.zeros(n, jnp.int32), box,
                          lj_kernel, lj_tables(1, r_cut=2.0), row_block=100)
    np.testing.assert_allclose(float(st.potential_energy), float(ref.energy),
                               rtol=1e-4)


def test_repack_preserves_physics():
    pos, n, box, spec, st, ovf = _fcc_case()
    st = packed_lj_force(st, spec)
    e0 = float(st.potential_energy)
    # drift positions (wrapped, as the MD loop always does), then repack
    from metadyn_tpu.ops.packed import _wrap_state
    st2 = _wrap_state(st.replace(r=st.r + 0.9))
    assert bool(needs_repack(st2, spec))
    st3, ovf2 = repack(st2, spec)
    assert not bool(ovf2)
    assert int((st3.pid < n).sum()) == n
    e_drift_repacked = float(packed_lj_force(st3, spec).potential_energy)
    # uniform drift doesn't change pair distances (after repack restores the
    # cell-implied minimum image; the un-repacked wrapped state is stale by
    # design — that's what needs_repack flags)
    np.testing.assert_allclose(e_drift_repacked, e0, rtol=1e-4)
    # pid→slot map is consistent
    up2 = np.asarray(unpack_positions(st3, spec))
    L = float(box.L[0])
    # compare per-particle modulo L (wrap conventions differ at exact ±L/2)
    d = up2 - (pos + 0.9)
    d -= L * np.round(d / L)
    np.testing.assert_allclose(d, 0.0, atol=1e-5)


def test_packed_pallas_interpret_matches_xla():
    """The Triton pair kernel (interpret mode) == the XLA roll sweep:
    forces, energy and virial."""
    pos, n, box, spec, st, ovf = _fcc_case()
    a = packed_lj_force(st, spec)
    b = _kernel(st, spec)
    np.testing.assert_allclose(float(a.potential_energy),
                               float(b.potential_energy), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(a.f), np.asarray(b.f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.virial), np.asarray(b.virial),
                               rtol=1e-4)


@pytest.mark.smoke
def test_packed_langevin_equilibrates(key):
    """MD with periodic repacks — without repacks the cell-implied min image
    goes stale and the run blows up (that failure mode is by design; the
    engine repacks every rebuild_every steps)."""
    pos, n, box, spec, st, ovf = _fcc_case(ncell=5, a=1.8)
    st = packed_lj_force(st, spec)
    kT = 1.0
    step = make_packed_langevin_step(
        lambda s: packed_lj_force(s, spec), dt=0.004, kT=kT, gamma=2.0)

    @jax.jit
    def run_block(st, key, nsteps=10):
        def body(s, i):
            return step(s, jax.random.fold_in(key, i)), None
        return jax.lax.scan(body, st, jnp.arange(nsteps))[0]

    any_ovf = False
    for b in range(40):
        st = run_block(st, jax.random.fold_in(key, b))
        st, ovf = repack(st, spec)
        any_ovf = any_ovf or bool(ovf)
    T = float(packed_temperature(st, spec))
    assert not any_ovf
    assert 0.8 < T < 1.25, T
    assert np.isfinite(float(st.potential_energy))


def test_packed_pallas2_interpret_matches_xla():
    """Kernel vs the full-sweep oracle on a jiggled lattice, and the
    force-only mode: same forces, the state's scalars left untouched."""
    pos, n, box, spec, st, ovf = _fcc_case()
    rng = np.random.default_rng(1)
    st = st.replace(r=st.r + jnp.asarray(
        rng.normal(0, 0.05, st.r.shape).astype(np.float32))
        * (st.pid < n)[None, :])
    a = packed_lj_force(st, spec)
    b = _kernel(st, spec)
    np.testing.assert_allclose(float(a.potential_energy),
                               float(b.potential_energy), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(a.f), np.asarray(b.f),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(a.virial), np.asarray(b.virial),
                               rtol=1e-3)
    st0 = st.replace(potential_energy=jnp.float32(123.0))
    c = _kernel(st0, spec, with_energy=False)
    np.testing.assert_allclose(np.asarray(b.f), np.asarray(c.f),
                               rtol=1e-5, atol=1e-5)
    assert float(c.potential_energy) == 123.0


def test_packed_cv_analytic_bias_force_matches_vjp():
    """accum_bias_force (the hot-path analytic gradient) == jax.vjp of the
    CV value function, for PackedLamellar and PackedMSD."""
    from metadyn_tpu.cv.packed import PackedLamellar, PackedMSD, \
        msd_reference_attrs
    from metadyn_tpu.core.state import make_system
    rng = np.random.default_rng(5)
    n, L = 400, 10.0
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=32)
    amps = rng.uniform(0.5, 1.5, n).astype(np.float32)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n),
                   extra_attrs={"lam_a": amps, **msd_reference_attrs(pos)})
    assert not bool(ovf)
    # drift the state a bit so MSD is nonzero
    st = st.replace(r=st.r + 0.01 * jnp.asarray(
        rng.normal(0, 1, st.r.shape).astype(np.float32)))
    system = make_system(n)
    cvs = [PackedLamellar.create([[0, 0, 3], [1, 2, 0]], n_real=n, name="a",
                                 phases=[0.3, -0.7]),
           PackedMSD(n_real=n)]
    dVds = jnp.asarray([0.8, -1.7], jnp.float32)
    # vjp oracle
    def stacked(r):
        st2 = st.replace(r=r)
        return jnp.stack([cv.value(st2, system) for cv in cvs])
    _, vjp = jax.vjp(stacked, st.r)
    (g,) = vjp(dVds)
    f_oracle = -np.asarray(g)
    # analytic path
    f = jnp.zeros_like(st.r)
    for i, cv in enumerate(cvs):
        f = cv.accum_bias_force(st, system, dVds[i], f)
    np.testing.assert_allclose(np.asarray(f), f_oracle, rtol=1e-4, atol=1e-6)


@pytest.mark.smoke
def test_packed_pallas2_uniform_sigma_matches_general():
    """The uniform-sigma lean kernel (no hs column, const sig, eps>0 gate)
    must match the general kernel exactly, including on a state where
    vacant slots have drifted off the origin (the 0*inf=NaN regime)."""
    from metadyn_tpu.utils.lattice import fcc_lattice
    rng = np.random.default_rng(7)
    a_lat = 1.7
    pos = fcc_lattice(6, a_lat)          # 864 particles, no overlaps
    n = pos.shape[0]
    L = 6 * a_lat
    pos = pos + rng.normal(0, 0.05, pos.shape).astype(np.float32)
    box = Box.cubic(L)
    outs = {}
    # ONE jiggle field shared by both runs: moves vacant slots to tiny
    # nonzero separations (the 0*inf=NaN regime for the uniform kernel)
    for uniform in (None, 1.0):
        spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40,
                                 uniform_sigma=uniform)
        st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                       jnp.ones(n), jnp.ones(n))
        assert not bool(ovf)
        jig = np.random.default_rng(11).normal(
            0, 1e-4, st.r.shape).astype(np.float32)
        st = st.replace(r=st.r + jnp.asarray(jig))
        outs[uniform] = _kernel(st, spec)
    a, b = outs[None], outs[1.0]
    assert np.isfinite(np.asarray(b.f)).all()
    np.testing.assert_allclose(np.asarray(a.f), np.asarray(b.f),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(a.potential_energy),
                               float(b.potential_energy), rtol=1e-5)


def _order_cv_state(seed=9):
    from metadyn_tpu.utils.lattice import fcc_lattice
    a_lat = 1.62
    pos = fcc_lattice(6, a_lat)
    n = pos.shape[0]
    L = 6 * a_lat
    rng = np.random.default_rng(seed)
    pos = pos + rng.normal(0, 0.08, pos.shape).astype(np.float32)
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n))
    assert not bool(ovf)
    return st, spec, n


@pytest.mark.smoke
def test_packed_order_cv_analytic_force_matches_vjp():
    """Q6 and coordination analytic accum_bias_force == jax.vjp of the
    value function (SURVEY.md §7 hard part 4 'grad first, fuse later' —
    the fused path with the autodiff oracle)."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.cv.packed_order import (
        PackedSteinhardtQl, PackedCoordination)
    st, spec, n = _order_cv_state()
    system = make_system(n)
    nn = 1.62 / np.sqrt(2)
    cvs = [PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6, name="q6"),
           PackedCoordination(spec=spec, r0=nn * 1.35, name="co")]
    dVds = jnp.asarray([0.9, -1.3], jnp.float32)

    def stacked(r):
        st2 = st.replace(r=r)
        return jnp.stack([cv.value(st2, system) for cv in cvs])

    _, vjp = jax.vjp(stacked, st.r)
    (g,) = vjp(dVds)
    f_oracle = -np.asarray(g)
    f = jnp.zeros_like(st.r)
    for i, cv in enumerate(cvs):
        f = cv.accum_bias_force(st, system, dVds[i], f)
    scale = np.abs(f_oracle).max()
    np.testing.assert_allclose(np.asarray(f), f_oracle,
                               rtol=2e-3, atol=2e-4 * scale)


@pytest.mark.smoke
def test_packed_order_half_sweep_matches_full():
    """Newton-halved value sweep == full 27-offset sweep (even-l parity)."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.cv.packed_order import (
        PackedSteinhardtQl, PackedCoordination, _offset_pair_sweep)
    st, spec, n = _order_cv_state(seed=4)
    system = make_system(n)
    nn = 1.62 / np.sqrt(2)
    for cv in (PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6),
               PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=4),
               PackedCoordination(spec=spec, r0=nn * 1.35)):
        v_half = float(cv.value(st, system))
        # full sweep via the internal helper
        if hasattr(cv, "_sums"):
            coeffs_fn = cv._sums  # uses half=True internally

            def per_pair_full(dx, dy, dz, r2, w):
                rcq2 = cv.r_cut ** 2
                from metadyn_tpu.cv.steinhardt import (
                    _plm_over_sinm_coeffs, _norms)
                w = w * (r2 < rcq2)
                r2s = jnp.where(r2 > 1e-12, r2, 1.0)
                inv_r = jax.lax.rsqrt(r2s)
                cth = dz * inv_r
                ux, uy = dx * inv_r, dy * inv_r
                pr, pi = jnp.ones_like(cth), jnp.zeros_like(cth)
                re, im = [], []
                coeffs = _plm_over_sinm_coeffs(cv.l)
                norms = _norms(cv.l)
                for m in range(cv.l + 1):
                    pl_ = jnp.zeros_like(cth)
                    for a in coeffs[m][::-1]:
                        pl_ = pl_ * cth + a
                    re.append(jnp.sum(w * norms[m] * pl_ * pr))
                    im.append(jnp.sum(w * norms[m] * pl_ * pi))
                    pr, pi = pr * ux - pi * uy, pr * uy + pi * ux
                return jnp.stack(re), jnp.stack(im), jnp.sum(w)

            from metadyn_tpu.cv.steinhardt import ql_from_sums
            re, im, nb = _offset_pair_sweep(st, spec, per_pair_full,
                                            half=False)
            v_full = float(ql_from_sums(re, im, nb, cv.l))
        else:
            r02 = cv.r0 ** 2

            def per_pair_full(dx, dy, dz, r2, w):
                y3 = (r2 / r02) ** 3
                return (jnp.sum(w / (1.0 + y3)),)

            (tot,) = _offset_pair_sweep(st, spec, per_pair_full, half=False)
            v_full = float(tot) / spec.n_real
        np.testing.assert_allclose(v_half, v_full, rtol=1e-5)


@pytest.mark.smoke
def test_packed_soft_pair_matches_all_pairs():
    """pair_kind='soft' on the packed engine == the all-pairs soft oracle
    (the true DPD-conservative push-off, replacing the small-epsilon LJ
    trick for melt preparation)."""
    from metadyn_tpu.ops.pairs import soft_tables, soft_kernel, \
        all_pairs_force
    rng = np.random.default_rng(12)
    n, L = 600, 12.0
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    box = Box.cubic(L)
    A = 25.0
    spec = PackedSpec.create(L, n, r_cut=1.0, skin=2.0, cap=24,
                             pair_kind="soft")
    # se = sqrt(A) per particle so A_ij = se_i*se_j = A
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   eps_i=jnp.full(n, A), sigma_i=jnp.ones(n))
    assert not bool(ovf)
    st = packed_lj_force(st, spec)
    ref = all_pairs_force(jnp.asarray(pos), jnp.zeros(n, jnp.int32), box,
                          soft_kernel, soft_tables(1, A=A, r_cut=1.0),
                          row_block=n)
    np.testing.assert_allclose(float(st.potential_energy),
                               float(ref.energy), rtol=1e-5)
    f_packed = np.asarray(st.f[:, st.slot_of].T)
    np.testing.assert_allclose(f_packed, np.asarray(ref.force),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.smoke
def test_packed_wte_energy_cv():
    """Well-tempered-ensemble mode on the packed hot path: with
    PackedEngine(with_energy=True) the potential energy is live every
    step, so an energy CV (reference WellTemperedEnsemble) can bias it."""
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler
    from metadyn_tpu.utils.lattice import fcc_lattice

    class PackedEnergyCV:
        """s = U — reads the live per-step potential energy."""
        log_name = "cv_U"

        def value(self, state, system):
            return state.potential_energy

        def accum_bias_force(self, state, system, dVds, f_acc):
            # dU/dr = -F  =>  bias force = -dVds * dU/dr = +dVds * F
            return f_acc + dVds * state.f

    a = 1.7
    pos = fcc_lattice(6, a)
    n = pos.shape[0]
    L = 6 * a
    from metadyn_tpu.core.box import Box as _Box
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=40)
    engine = PackedEngine(spec, rebuild_every=5, with_energy=True)
    system = make_system(n)
    rng = np.random.default_rng(0)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    st, ovf = engine.pack_state(pos, _Box.cubic(L), jnp.zeros(n, jnp.int32),
                                eps_i=jnp.ones(n), sigma_i=jnp.ones(n),
                                vel=vel)
    assert not bool(ovf)
    e0 = float(engine.init(st)[0].potential_energy)
    gs = GridSpec.create([e0 - 800], [e0 + 800], [81], [40.0])
    s = MetadSampler(
        system, st, engine, cvs=[PackedEnergyCV()], grid_spec=gs,
        hills=HillSpec.create(W=10.0, stride=25, mode=WELL_TEMPERED,
                              deltaT=500.0),
        integrator_factory=lambda f: make_packed_langevin_step(
            f, dt=0.004, kT=1.0, gamma=1.0),
        seed=0, chunks_per_block=2)
    hist = s.run(200)
    m = hist[-1]
    assert np.isfinite(float(m["cv"][0]))
    assert float(np.asarray(s.bias.grid.V).max()) > 1.0
    assert not bool(m["nlist_overflow"])


def test_packed_pallas2_uniform_eps_sentinel_matches_general():
    """The fully-lean kernel (uniform eps + sigma: NO se/hs stacks,
    vacancy via the VACANT_X coordinate sentinel) must match the general
    kernel on real slots, including after vacant slots drift under noise."""
    from metadyn_tpu.utils.lattice import fcc_lattice
    a_lat = 1.7
    pos = fcc_lattice(6, a_lat)
    n = pos.shape[0]
    L = 6 * a_lat
    rng = np.random.default_rng(3)
    pos = pos + rng.normal(0, 0.05, pos.shape).astype(np.float32)
    box = Box.cubic(L)
    outs = {}
    for lean in (False, True):
        spec = PackedSpec.create(
            L, n, r_cut=2.5, skin=0.4, cap=40,
            uniform_sigma=1.0 if lean else None,
            uniform_eps=1.0 if lean else None)
        st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                       jnp.ones(n), jnp.ones(n))
        assert not bool(ovf)
        # drift ALL slots (incl. vacant/sentinel) as Langevin noise does
        noise = np.random.default_rng(7).normal(
            0, 1e-3, st.r.shape).astype(np.float32)
        st = st.replace(r=st.r + jnp.asarray(noise))
        outs[lean] = (_kernel(st, spec), st)
    (a, sta), (b, stb) = outs[False], outs[True]
    fa = np.asarray(a.f[:, sta.slot_of])   # real-slot forces
    fb = np.asarray(b.f[:, stb.slot_of])
    assert np.isfinite(np.asarray(b.f)).all()
    np.testing.assert_allclose(fa, fb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(a.potential_energy),
                               float(b.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a.virial), np.asarray(b.virial), rtol=1e-5)


@pytest.mark.smoke
def test_packed_uniform_eps_md_block():
    """Short MD with the lean kernel under repack: trajectories match the
    general-kernel engine bitwise-closely (sentinel reapplied at repack)."""
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.utils.lattice import fcc_lattice
    a_lat = 1.7
    pos = fcc_lattice(5, a_lat)
    n = pos.shape[0]
    L = 5 * a_lat
    box = Box.cubic(L)
    rng = np.random.default_rng(0)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    res = {}
    for lean in (False, True):
        spec = PackedSpec.create(
            L, n, r_cut=2.0, skin=0.4, cap=32,
            uniform_sigma=1.0 if lean else None,
            uniform_eps=1.0 if lean else None)
        engine = PackedEngine(spec, rebuild_every=5, pair_path="triton",
                              interpret=True)
        st, ovf = engine.pack_state(pos, box, jnp.zeros(n, jnp.int32),
                                    eps_i=jnp.ones(n),
                                    sigma_i=jnp.ones(n), vel=vel)
        assert not bool(ovf)
        st, aux = engine.init(st)
        step = make_packed_langevin_step(
            lambda s: engine.force_into(s, None), dt=0.004, kT=1.0,
            gamma=1.0)

        @jax.jit
        def run(st, aux):
            def blk(c, b):
                s2, a2 = engine.rebuild(*c)
                def body(s, i):
                    return step(s, jax.random.fold_in(
                        jax.random.PRNGKey(5), b * 5 + i)), None
                s2, _ = jax.lax.scan(body, s2, jnp.arange(5))
                return (s2, a2), None
            return jax.lax.scan(blk, (st, aux), jnp.arange(6))[0]

        st, aux = run(st, aux)
        assert not bool(aux.overflow)
        # the load-bearing sentinel invariant: integrators + repacks
        # must keep vacant slots pinned at EXACTLY VACANT_X
        from metadyn_tpu.ops.packed import assert_no_vacant_drift
        assert_no_vacant_drift(st, spec)
        res[lean] = np.asarray(st.r[:, st.slot_of])
    np.testing.assert_allclose(res[False], res[True], rtol=1e-5, atol=1e-5)


@pytest.mark.smoke
def test_packed_force_j_chunking_matches_full():
    """The memory-bounded j-chunked XLA force == the full-block path
    (chunking auto-engages at ~1M-particle scale where (cap,cap,C)
    pair blocks exceed HBM)."""
    from metadyn_tpu.ops.packed import bond_partner_attrs
    rng = np.random.default_rng(6)
    n, L = 500, 12.0
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    bonds = np.stack([np.arange(0, 40, 2), np.arange(1, 40, 2)], 1)
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=1.0, cap=24,
                             fene_k=30.0, fene_r0=1.5)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n),
                   extra_attrs=bond_partner_attrs(bonds, n))
    assert not bool(ovf)
    full = packed_lj_force(st, spec)
    for jb in (8, 16):  # 24 % 16 != 0 exercises the padded tail
        ch = packed_lj_force(st, spec, j_block=jb)
        # f32 summation-order differences only
        np.testing.assert_allclose(np.asarray(ch.f), np.asarray(full.f),
                                   rtol=5e-5, atol=2e-2)
        np.testing.assert_allclose(float(ch.potential_energy),
                                   float(full.potential_energy), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(ch.virial), np.asarray(full.virial),
                                   rtol=1e-6)


@pytest.mark.smoke
def test_packed_npt_scr_targets_pressure():
    """NPT on the packed hot path (VERDICT r2 missing #4): the SCR
    barostat driven by the per-step packed virial equilibrates the LJ
    liquid at the target pressure; slot<->cell assignment survives the
    rescaling (fractional mapping)."""
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.integrate.packed import make_packed_npt_scr_step

    kT, P = 1.2, 1.0
    a = 1.75
    pos = fcc_lattice(4, a)
    n = pos.shape[0]
    L = 4 * a
    box = Box.cubic(L)
    rng = np.random.default_rng(0)
    vel = rng.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    # headroom: generous skin so the static cell grid tolerates box
    # breathing (cell width stays >= r_list under modest compression)
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.3, cap=24)
    engine = PackedEngine(spec, rebuild_every=5, pair_path="xla",
                          with_energy=True)
    st, ovf = engine.pack_state(pos, box, jnp.zeros(n, jnp.int32),
                                eps_i=jnp.ones(n), sigma_i=jnp.ones(n),
                                vel=vel)
    assert not bool(ovf)
    st, aux = engine.init(st)
    step = make_packed_npt_scr_step(
        lambda s: engine.force_into(s, None), spec,
        dt=0.004, kT=kT, pressure=P, gamma=2.0, tau_p=1.0)

    import functools

    @functools.partial(jax.jit, static_argnums=3)
    def run(st, aux, key, nb):
        def block(c, b):
            s2, a2 = engine.rebuild(*c)
            def body(s, i):
                return step(s, jax.random.fold_in(key, b * 5 + i)), None
            s2, _ = jax.lax.scan(body, s2, jnp.arange(5))
            return (s2, a2), None
        return jax.lax.scan(block, (st, aux), jnp.arange(nb))[0]

    st, aux = run(st, aux, jax.random.PRNGKey(1), 300)   # 1500 equil steps
    assert not bool(aux.overflow)
    ps, vols = [], []
    for i in range(8):
        st, aux = run(st, aux, jax.random.PRNGKey(50 + i), 25)
        valid = (np.asarray(st.pid) < n).astype(np.float32)
        ke2 = float(np.sum(np.asarray(st.v) ** 2 * valid[None, :]))
        p = (ke2 / 3.0 + float(np.asarray(st.virial).sum()) / 3.0) \
            / float(np.asarray(st.box.volume))
        ps.append(p)
        vols.append(float(np.asarray(st.box.volume)))
    p_mean = np.mean(ps)
    assert abs(p_mean - P) < 0.45, (p_mean, ps)
    assert np.std(vols) > 0      # box actually breathes
    assert not bool(aux.overflow)


@pytest.mark.smoke
def test_packed_box_shape_metadynamics_smoke():
    """Box-shape metadynamics END-TO-END on the packed engine (VERDICT
    r2 missing #4): aspect-ratio CV hills coupled to the box DOF inside
    the jitted chunk, anisotropic SCR with the TRUE per-axis packed
    virial."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.integrate.packed import make_packed_npt_scr_step
    from metadyn_tpu.cv.aspect_ratio import AspectRatio, box_bias_fn_for
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler

    kT, P = 1.0, 0.5
    a = 1.8
    pos = fcc_lattice(4, a)
    n = pos.shape[0]
    L = 4 * a
    rng = np.random.default_rng(3)
    vel = rng.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.4, cap=32)
    engine = PackedEngine(spec, rebuild_every=5, pair_path="xla",
                          with_energy=True)
    st, ovf = engine.pack_state(pos, Box.cubic(L), jnp.zeros(n, jnp.int32),
                                eps_i=jnp.ones(n), sigma_i=jnp.ones(n),
                                vel=vel)
    assert not bool(ovf)
    cv = AspectRatio()

    def factory(f, bias):
        return make_packed_npt_scr_step(
            f, spec, dt=0.004, kT=kT, pressure=P, gamma=2.0, tau_p=1.0,
            anisotropic=True, box_bias_fn=box_bias_fn_for(cv, bias))

    sampler = MetadSampler(
        make_system(n), st, engine, cvs=[cv],
        grid_spec=GridSpec.create([0.6], [1.6], [41], [0.03]),
        hills=HillSpec.create(W=0.3, stride=50, mode=WELL_TEMPERED,
                              deltaT=4.0),
        integrator_factory=factory, seed=0, chunks_per_block=2)
    hist = sampler.run(400)
    m = hist[-1]
    assert np.isfinite(m["potential_energy"]).all()
    assert not bool(m["nlist_overflow"])
    assert int(sampler.bias.n_hills) == 8
    L3 = np.asarray(sampler.state.box.L)
    assert np.all(np.isfinite(L3)) and np.all(L3 > 0)
    s = float(L3[0] / L3[1])
    assert 0.5 < s < 2.0


@pytest.mark.smoke
def test_neighbor_table_matches_roll_sweep():
    """Table-path order CVs (values + bias forces over the slot neighbor
    table) == the roll-sweep path, and the table itself is complete:
    every pair within r_nb is listed from both sides."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.cv.packed_order import (
        PackedSteinhardtQl, PackedCoordination, make_fused_order_force,
        make_table_order_force)
    from metadyn_tpu.ops.neighbor_table import build_slot_neighbor_table

    st, spec, n = _order_cv_state(seed=11)
    system = make_system(n)
    nn = 1.62 / np.sqrt(2)
    cvs = [PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6, name="q6"),
           PackedCoordination(spec=spec, r0=nn * 1.35, name="co",
                              r_cut=nn * 1.35 * 1.5)]
    r_nb = cvs[1].r_cut + spec.skin
    K = 96
    tbl, ovf = build_slot_neighbor_table(st, spec, r_nb, K)
    assert not bool(ovf)
    tbl_np = np.asarray(tbl)

    # completeness + symmetry oracle vs O(N^2) distances
    from metadyn_tpu.ops.packed import unpack_positions
    pos = np.asarray(unpack_positions(st, spec))
    slot_of = np.asarray(st.slot_of)
    L = float(st.box.L[0])
    d = pos[:, None, :] - pos[None, :, :]
    d -= L * np.round(d / L)
    r2 = (d ** 2).sum(-1)
    within = (r2 < r_nb ** 2) & ~np.eye(n, dtype=bool)
    deg = within.sum(1)
    listed = (tbl_np < spec.n_pad).sum(0)[slot_of]
    np.testing.assert_array_equal(listed, deg)
    # spot-check: every true neighbor pair is present
    for i in np.random.default_rng(0).integers(0, n, 20):
        js = np.where(within[i])[0]
        got = set(tbl_np[:, slot_of[i]][tbl_np[:, slot_of[i]] < spec.n_pad])
        assert got == set(slot_of[js])

    # values match the roll path
    vals_roll, force_roll = make_fused_order_force(cvs, spec)
    vals_tbl, force_tbl = make_table_order_force(cvs, spec)
    s_r, ctx_r = vals_roll(st)
    s_t, ctx_t = vals_tbl(st, tbl)
    np.testing.assert_allclose(np.asarray(s_t), np.asarray(s_r), rtol=2e-5)

    # bias forces match the roll path
    dVds = jnp.asarray([0.9, -1.3], jnp.float32)
    g_r = np.asarray(force_roll(st, ctx_r, dVds))
    g_t = np.asarray(force_tbl(st, tbl, ctx_t, dVds))
    scale = np.abs(g_r).max()
    np.testing.assert_allclose(g_t, g_r, rtol=2e-3, atol=2e-4 * scale)


@pytest.mark.smoke
def test_neighbor_table_mtd_run_with_repack():
    """Biased MD on a table engine: migrations trigger table rebuilds
    inside the repack cond; CV values stay consistent with the roll path
    afterwards, nothing overflows."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.cv.packed_order import (
        PackedSteinhardtQl, PackedCoordination)
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler

    st, spec, n = _order_cv_state(seed=12)
    system = make_system(n)
    nn = 1.62 / np.sqrt(2)
    q6 = PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6, name="q6")
    co = PackedCoordination(spec=spec, r0=nn * 1.35, name="co",
                            r_cut=nn * 1.35 * 1.5)
    engine = PackedEngine(spec, rebuild_every=5, pair_path="xla",
                          nbr_table=(co.r_cut + spec.skin, 96))
    s0 = [float(q6.value(st, system)), float(co.value(st, system))]
    grid = GridSpec.create([0.0, 0.0], [0.7, s0[1] * 2.0], [24, 24],
                           [0.02, s0[1] / 15])
    sampler = MetadSampler(
        system, st, engine, cvs=[q6, co], grid_spec=grid,
        hills=HillSpec.create(W=0.4, stride=20, mode=WELL_TEMPERED,
                              deltaT=5.0),
        integrator_factory=lambda f: make_packed_langevin_step(
            f, dt=0.004, kT=0.7, gamma=1.0),
        seed=0, chunks_per_block=2)
    hist = sampler.run(80)
    m = hist[-1]
    assert not bool(m["nlist_overflow"])
    assert int(sampler.bias.n_hills) == 4
    # the stride-end CV (roll path) and the table values the deposit
    # used agree: deposits landed on-grid and finite
    assert np.isfinite(np.asarray(m["cv"])).all()
    assert not bool(m["cv_out_of_grid"])
    # the current state's table value == roll value (table is fresh)
    from metadyn_tpu.cv.packed_order import make_table_order_force
    vt, _ = make_table_order_force([q6, co], spec)
    s_t, _ctx = vt(sampler.state, sampler.carry.aux.nbr)
    s_r = [float(q6.value(sampler.state, system)),
           float(co.value(sampler.state, system))]
    np.testing.assert_allclose(np.asarray(s_t), s_r, rtol=5e-5)


@pytest.mark.slow
@pytest.mark.smoke
def test_packed_mts_bias_every_smoke():
    """bias_every=5 on the packed order-CV path: the MTS chunk (CV sweeps
    once per 5 steps, bias force held) runs biased MD with the same
    deposit schedule and lands in the same macrostate as every-step."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.cv.packed_order import (
        PackedSteinhardtQl, PackedCoordination)
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED
    from metadyn_tpu.sampler import MetadSampler

    nn = 1.62 / np.sqrt(2)

    def make(bias_every):
        st, spec, n = _order_cv_state(seed=13)
        system = make_system(n)
        q6 = PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6, name="q6")
        co = PackedCoordination(spec=spec, r0=nn * 1.35, name="co",
                                r_cut=nn * 1.35 * 1.5)
        engine = PackedEngine(spec, rebuild_every=10, pair_path="xla")
        grid = GridSpec.create([0.0, 0.0], [0.7, 30.0], [24, 24],
                               [0.02, 0.6])
        return MetadSampler(
            system, st, engine, cvs=[q6, co], grid_spec=grid,
            hills=HillSpec.create(W=0.4, stride=20, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.004, kT=0.7, gamma=1.0),
            seed=0, chunks_per_block=2, bias_every=bias_every)

    res = {}
    for k in (1, 5):
        s = make(k)
        hist = s.run(100)
        m = hist[-1]
        assert not bool(m["nlist_overflow"])
        assert int(s.bias.n_hills) == 5
        assert np.isfinite(np.asarray(m["cv"])).all()
        res[k] = np.asarray(m["cv"])
    # same seed, slowly-varying bias force: the 100-step endpoints agree
    # to the MTS perturbation scale (not bitwise — different force seq)
    np.testing.assert_allclose(res[5], res[1], rtol=0.05, atol=0.05)


@pytest.mark.parametrize("sentinel", [False, True],
                         ids=["validity", "sentinel"])
def test_packed_order_sweep_matches_references(sentinel):
    """The fused XLA order sweep (the path Config 3 runs on every
    platform) == plain references, in both vacancy encodings: Q6 against
    cv.steinhardt.SteinhardtQl on the unpacked positions, coordination
    against a direct O(N²) minimum-image sum of the stretched switching
    function."""
    from metadyn_tpu.cv.packed_order import (
        PackedSteinhardtQl, PackedCoordination, make_fused_order_force)
    from metadyn_tpu.cv.steinhardt import SteinhardtQl
    from metadyn_tpu.core.state import make_state, make_system
    from metadyn_tpu.utils.lattice import fcc_lattice

    a_lat = 1.62
    pos = fcc_lattice(6, a_lat)
    n = pos.shape[0]
    L = 6 * a_lat
    rng = np.random.default_rng(5)
    pos = pos + rng.normal(0, 0.08, pos.shape).astype(np.float32)
    box = Box.cubic(L)
    kw = dict(uniform_sigma=1.0, uniform_eps=1.0) if sentinel else {}
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40, **kw)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n))
    assert not bool(ovf)

    nn = a_lat / np.sqrt(2)
    rq, r0 = nn * 1.2, nn * 1.35
    rc = r0 * 1.5
    cvs = [PackedSteinhardtQl(spec=spec, r_cut=rq, l=6, name="q6"),
           PackedCoordination(spec=spec, r0=r0, name="co", r_cut=rc)]
    values, _ = make_fused_order_force(cvs, spec)
    s, _ = values(st)

    system = make_system(n)
    pstate = make_state(jnp.asarray(np.asarray(unpack_positions(st, spec))),
                        box)
    q6_ref = SteinhardtQl(r_cut=rq, l=6).value(pstate, system)
    np.testing.assert_allclose(float(s[0]), float(q6_ref), rtol=2e-4)

    p = np.asarray(unpack_positions(st, spec), np.float64)
    d = p[:, None, :] - p[None, :, :]
    d -= L * np.round(d / L)
    r2 = (d * d).sum(-1)
    np.fill_diagonal(r2, np.inf)
    sw = 1.0 / (1.0 + (r2 / r0 ** 2) ** 3)
    sc = 1.0 / (1.0 + (rc / r0) ** 6)
    coord = np.where(r2 < rc ** 2, (sw - sc) / (1.0 - sc), 0.0).sum() / n
    np.testing.assert_allclose(float(s[1]), coord, rtol=2e-5)


def test_packed_npt_cell_width_guard():
    """VERDICT r3 item 8: sustained NPT compression against the static
    cell grid trips the ``cell_width_violation`` metric flag BEFORE the
    physics silently degrades (the docstring caveat is now a guard)."""
    from metadyn_tpu.core.packed_engine import PackedEngine
    from metadyn_tpu.integrate.packed import make_packed_npt_scr_step

    pos, n, box, spec, st, ovf = _fcc_case(ncell=5, a=1.9)
    engine = PackedEngine(spec, rebuild_every=5, pair_path="xla",
                          with_energy=True)
    st, aux = engine.init(st)
    m0 = jax.device_get(engine.metrics(st, aux))
    assert not bool(m0["cell_width_violation"])

    # direct check: a shrunken box flips the flag exactly at r_list
    L0 = float(box.L[0])
    cx = spec.cells_per_dim[0]
    L_crit = spec.r_list * cx
    shrunk = st.replace(box=st.box.replace(
        L=jnp.asarray([L_crit * 0.98] * 3, jnp.float32)))
    m1 = jax.device_get(engine.metrics(shrunk, aux))
    assert bool(m1["cell_width_violation"])

    # dynamic check: a strong SCR-NPT compression trips the flag while
    # the state is still finite (loud before wrong)
    step = make_packed_npt_scr_step(
        lambda s: engine.force_into(s, aux), spec, dt=0.004, kT=1.0,
        pressure=60.0, tau_p=0.5, kappa=0.4)

    @jax.jit
    def block(c, key):
        st2, a2 = c
        st2, a2 = engine.rebuild(st2, a2)

        def body(s2, i):
            return step(s2, jax.random.fold_in(key, i)), None

        st2, _ = jax.lax.scan(body, st2, jnp.arange(5))
        return (st2, a2)

    tripped = False
    for b in range(120):
        st, aux = block((st, aux), jax.random.fold_in(jax.random.PRNGKey(3), b))
        m = jax.device_get(engine.metrics(st, aux))
        if bool(m["cell_width_violation"]):
            tripped = True
            assert np.isfinite(float(st.potential_energy))
            assert np.isfinite(np.asarray(st.r[:, st.pid < spec.n_real])).all()
            break
    assert tripped, "compression never tripped the cell-width guard"
