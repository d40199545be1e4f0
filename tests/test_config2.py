"""Config 2 (BASELINE.json:8): well-tempered MTD, 1D S(k) CV, bead-spring
diblock copolymer melt — end-to-end on the packed engine (CPU-sized)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metadyn_tpu.core.box import Box
from metadyn_tpu.core.state import make_state, make_system
from metadyn_tpu.core.packed_engine import PackedEngine
from metadyn_tpu.ops.packed import PackedSpec, pack, bond_partner_attrs
from metadyn_tpu.cv.packed import PackedMesh
from metadyn_tpu.cv.mesh import MeshOrderParameter
from metadyn_tpu.bias.grid import GridSpec
from metadyn_tpu.bias.metad import HillSpec, WallSpec, WELL_TEMPERED
from metadyn_tpu.integrate.packed import make_packed_langevin_step
from metadyn_tpu.sampler import MetadSampler
from metadyn_tpu.utils.lattice import polymer_melt

from tests.test_packed_bonds import _relaxed_melt


def _diblock_types(n_chains, chain_len):
    """First half of each chain type A (coef +1), second half B (−1)."""
    t = np.zeros((n_chains, chain_len), np.int32)
    t[:, chain_len // 2:] = 1
    return t.reshape(-1)


@pytest.mark.smoke
@pytest.mark.parametrize("order", [2, 3], ids=["cic", "tsc"])
def test_packed_mesh_matches_particle_order(order):
    pos, bonds, _ = _relaxed_melt(n_chains=12, chain_len=8)
    n = pos.shape[0]
    L = 12.0
    box = Box.cubic(L)
    types = _diblock_types(12, 8)
    coef = np.asarray([1.0, -1.0], np.float32)[types]
    k0 = 2 * np.pi * 2 / L

    ref_cv = MeshOrderParameter.create((16, 16, 16), L, mode=[1.0, -1.0],
                                       k0=k0, assign_order=order)
    system = make_system(n, types=types)
    s_ref = float(ref_cv.value(make_state(pos, box), system))

    spec = PackedSpec.create(L, n, r_cut=2 ** (1 / 6), skin=0.4, cap=32,
                             fene_k=30.0, fene_r0=1.5)
    cv = PackedMesh.create((16, 16, 16), L, n_real=n, k0=k0,
                           assign_order=order)
    st, ovf = pack(pos, box, spec, jnp.asarray(types), jnp.ones(n), jnp.ones(n),
                   extra_attrs={**bond_partner_attrs(bonds, n),
                                cv.attr_name: coef})
    assert not bool(ovf)
    s_packed = float(cv.value(st, system))
    np.testing.assert_allclose(s_packed, s_ref, rtol=1e-4)


@pytest.mark.parametrize("n_steps", [
    pytest.param(125, id="smoke"),
    pytest.param(500, id="full", marks=pytest.mark.slow),
])
@pytest.mark.smoke
def test_config2_diblock_wt_mtd_end_to_end(n_steps):
    """Diblock melt + WT-MTD on the A−B S(k) CV: the bias drives
    microphase separation (the CV grows) and everything stays finite."""
    n_chains, chain_len = 20, 10
    pos, bonds, _ = _relaxed_melt(n_chains=n_chains, chain_len=chain_len,
                                  L=12.0, seed=0)
    n = pos.shape[0]
    L = 12.0
    box = Box.cubic(L)
    types = _diblock_types(n_chains, chain_len)
    coef = np.asarray([1.0, -1.0], np.float32)[types]
    system = make_system(n, types=types, bonds=bonds)
    k0 = 2 * np.pi * 1 / L  # lamellar period = box

    spec = PackedSpec.create(L, n, r_cut=2 ** (1 / 6), skin=0.5, cap=16,
                             fene_k=30.0, fene_r0=1.5)
    engine = PackedEngine(spec, pair_path="xla")
    cv = PackedMesh.create((12, 12, 12), L, n_real=n, k0=k0, width=0.3)
    st, ovf = engine.pack_state(
        pos, box, jnp.asarray(types), eps_i=jnp.ones(n), sigma_i=jnp.ones(n),
        extra_attrs={**bond_partner_attrs(bonds, n), cv.attr_name: coef})
    assert not bool(ovf)
    # size the grid around the melt's actual initial S(k)
    s0 = float(cv.value(st, system))
    grid = GridSpec.create([0.0], [max(4.0 * s0, 8.0)], [101],
                           [max(4.0 * s0, 8.0) / 40])
    s = MetadSampler(
        system, st, engine, cvs=[cv], grid_spec=grid,
        hills=HillSpec.create(W=0.3, stride=25, mode=WELL_TEMPERED, deltaT=3.0),
        integrator_factory=lambda f: make_packed_langevin_step(
            f, dt=0.003, kT=1.0, gamma=1.0),
        walls=WallSpec.at_grid_edges(grid, k=500.0),
        seed=0,
    )
    hist = s.run(n_steps)
    cvs_t = np.asarray([h["cv"][0] for h in hist])
    assert np.all(np.isfinite(cvs_t))
    assert not any(h["nlist_overflow"] for h in hist)
    assert int(s.bias.n_hills) == n_steps // 25
    if n_steps >= 500:
        # the bias should push the melt to explore larger S(k)
        assert cvs_t[-10:].mean() > cvs_t[:5].mean(), (
            cvs_t[:5].mean(), cvs_t[-10:].mean())
