"""Config 3 (BASELINE.json:9): 2D CV (Steinhardt Q6 + coordination/density)
on the packed engine — crystal-nucleation-style setup, CPU-sized."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metadyn_tpu.core.box import Box
from metadyn_tpu.core.state import make_state, make_system
from metadyn_tpu.core.packed_engine import PackedEngine
from metadyn_tpu.ops.packed import PackedSpec, pack
from metadyn_tpu.cv.packed_order import PackedSteinhardtQl, PackedCoordination
from metadyn_tpu.cv.steinhardt import SteinhardtQl
from metadyn_tpu.bias.grid import GridSpec
from metadyn_tpu.bias.metad import HillSpec, WallSpec, WELL_TEMPERED
from metadyn_tpu.integrate.packed import make_packed_langevin_step
from metadyn_tpu.sampler import MetadSampler
from metadyn_tpu.utils.lattice import fcc_lattice


def _packed_fcc(ncell=6, a=1.7, r_cut=2.5, skin=0.5):
    pos = fcc_lattice(ncell, a)
    n = pos.shape[0]
    L = ncell * a
    box = Box.cubic(L)
    # tight-ish cap keeps the CPU (cap, cap, C) sweeps affordable in CI
    spec = PackedSpec.create(L, n, r_cut=r_cut, skin=skin, cap=48)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32),
                   jnp.ones(n), jnp.ones(n))
    assert not bool(ovf)
    return pos, n, L, box, spec, st


def test_packed_q6_matches_particle_order():
    pos, n, L, box, spec, st = _packed_fcc()
    system = make_system(n)
    nn = 1.7 / np.sqrt(2)
    cv_p = PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6)
    cv_ref = SteinhardtQl(r_cut=nn * 1.2, l=6, row_block=216)
    q_p = float(cv_p.value(st, system))
    q_ref = float(cv_ref.value(make_state(pos, box), system))
    np.testing.assert_allclose(q_p, q_ref, rtol=1e-4)
    np.testing.assert_allclose(q_p, 0.57452, atol=2e-3)  # fcc oracle


def test_packed_coordination_fcc():
    pos, n, L, box, spec, st = _packed_fcc()
    system = make_system(n)
    nn = 1.7 / np.sqrt(2)
    cv = PackedCoordination(spec=spec, r0=nn * 1.35)
    c = float(cv.value(st, system))
    # 12 nearest neighbors ≈ 12 plus the slow r⁻⁶ switching tail over the
    # 2nd/3rd shells (truncated at the stencil r_list)
    assert 15.0 < c < 26.0, c


@pytest.mark.smoke
def test_packed_order_cvs_differentiable():
    pos, n, L, box, spec, st = _packed_fcc(ncell=6)
    system = make_system(n)
    nn = 1.7 / np.sqrt(2)
    q6 = PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6)
    co = PackedCoordination(spec=spec, r0=nn * 1.35)
    for cv in (q6, co):
        g = jax.grad(lambda r: cv.value(st.replace(r=r), system))(st.r)
        assert np.all(np.isfinite(np.asarray(g))), cv.name


@pytest.mark.parametrize("n_steps,n_hills,marker", [
    pytest.param(20, 1, "smoke", id="smoke"),
    pytest.param(100, 5, "full", id="full", marks=pytest.mark.slow),
])
@pytest.mark.smoke
def test_config3_2d_cv_mtd_runs(n_steps, n_hills, marker):
    """64k-shaped (here small) 2D-CV WT-MTD: Q6 × coordination grid bias with
    forces through both CVs — the Config-3 capability slice."""
    pos, n, L, box, spec, st = _packed_fcc(ncell=6, a=1.75)
    system = make_system(n)
    engine = PackedEngine(spec, pair_path="xla")
    st, aux0 = engine.init(st)
    nn = 1.75 / np.sqrt(2)
    q6 = PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6, name="q6")
    co = PackedCoordination(spec=spec, r0=nn * 1.35, name="coord")
    s0 = [float(q6.value(st, system)), float(co.value(st, system))]
    grid = GridSpec.create([0.0, 0.0], [0.7, s0[1] * 2.0], [32, 32],
                           [0.02, s0[1] / 20])
    s = MetadSampler(
        system, st, engine, cvs=[q6, co], grid_spec=grid,
        hills=HillSpec.create(W=0.5, stride=20, mode=WELL_TEMPERED, deltaT=5.0),
        integrator_factory=lambda f: make_packed_langevin_step(
            f, dt=0.004, kT=0.7, gamma=1.0),
        walls=WallSpec.at_grid_edges(grid, k=200.0),
        seed=0,
    )
    hist = s.run(n_steps)
    assert int(s.bias.n_hills) == n_hills
    m = hist[-1]
    assert np.isfinite(m["cv"]).all() and np.isfinite(m["potential_energy"])
    assert not m["nlist_overflow"]
    # the crystal melts/disorders under kT=0.7 + bias: Q6 decreases from fcc
    assert m["cv"][0] < s0[0], (m["cv"], s0)
