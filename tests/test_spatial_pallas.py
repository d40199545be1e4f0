"""The Triton pair kernel inside the spatial shard_map islands.

Correctness argument (see make_sharded_lj_force): interior i-cells have
all 26 neighbour cells inside the halo-extended local grid, so their
forces are exact; ghost-plane forces are discarded and the cell mask
keeps ghost i-cells out of the energy/virial sums.  These tests pin the
kernel path (interpret mode) against the XLA cell-mask island, whose
trajectory-level differential vs the single-device engine lives in
test_spatial.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from metadyn_tpu.core.box import Box
from metadyn_tpu.ops.packed import PackedSpec
from metadyn_tpu.parallel.spatial import SpatialPackedEngine
from metadyn_tpu.utils.lattice import fcc_lattice


# default tier runs the production combination (sentinel layout, 1-D);
# the remaining cross-products land in the smoke tier
@pytest.mark.parametrize(
    "dd", ["1d", pytest.param("2d", marks=pytest.mark.smoke)])
@pytest.mark.parametrize(
    "sentinel", [pytest.param(False, marks=pytest.mark.smoke), True],
    ids=["general", "sentinel"])
def test_spatial_pair_pallas_matches_xla(sentinel, dd):
    """Triton pair kernel on the halo-extended local grid == the XLA
    cell-mask island, for BOTH decompositions: forces on inner steps,
    and energy + virial on the refresh path."""
    from metadyn_tpu.parallel.spatial2d import SpatialPackedEngine2D

    a = 2.0
    pos = fcc_lattice(4, a)   # 256 particles; cx = 4 divides over 2 shards
    n = pos.shape[0]
    L = 4 * a
    box = Box.cubic(L)
    rng = np.random.default_rng(4)
    pos = pos + rng.normal(0, 0.06, pos.shape).astype(np.float32)
    kw = dict(uniform_sigma=1.0, uniform_eps=1.0) if sentinel else {}

    def forces(pair_path):
        spec = PackedSpec.create(L, n, r_cut=1.5, skin=0.5, cap=16,
                                 shift_energy=False, **kw)
        if dd == "1d":
            mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
            engine = SpatialPackedEngine(spec, mesh, rebuild_every=5,
                                         pair_path=pair_path,
                                         interpret=True)
        else:
            mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                        ("spacex", "spacey"))
            engine = SpatialPackedEngine2D(spec, mesh, rebuild_every=5,
                                           pair_path=pair_path,
                                           interpret=True)
        assert engine.pair_path == pair_path
        assert engine.energy_live == (pair_path == "xla")
        st, ovf = engine.pack_state(
            pos, box, np.zeros(n, np.int32), eps_i=np.ones(n, np.float32),
            sigma_i=np.ones(n, np.float32))
        assert not bool(ovf)
        f = jax.jit(lambda s: engine.force_into(s, None).f)(st)
        ref = jax.jit(lambda s: engine.refresh_energy(s, None))(st)
        return (np.asarray(f), float(ref.potential_energy),
                np.asarray(ref.virial))

    f_p, e_p, w_p = forces("triton")
    f_x, e_x, w_x = forces("xla")

    scale = np.abs(f_x).max()
    np.testing.assert_allclose(f_p, f_x, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(e_p, e_x, rtol=1e-5)
    np.testing.assert_allclose(w_p, w_x, rtol=1e-4)


@pytest.mark.smoke
def test_product_mesh_pallas_kernels_match_xla():
    """The Triton pair kernel inside NESTED (walkers x space) islands.
    2 walkers x 2 shards, 50 biased MD steps with Q6 + coordination:
    trajectories and the shared bias grid match the XLA-path product
    run."""
    from metadyn_tpu.core.state import make_system
    from metadyn_tpu.cv.packed_order import (PackedSteinhardtQl,
                                             PackedCoordination)
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.walkers import WalkerSampler
    from metadyn_tpu.integrate.packed import make_packed_langevin_step
    from metadyn_tpu.bias.grid import GridSpec
    from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED

    a_lat = 1.62
    pos = fcc_lattice(8, a_lat)
    n = pos.shape[0]
    L = 8 * a_lat
    rng = np.random.default_rng(3)
    pos = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    box = Box.cubic(L)
    system = make_system(n)
    nn = a_lat / np.sqrt(2)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=40,
                             shift_energy=False)
    grid = GridSpec.create([0.0, 4.0], [0.7, 28.0], [32, 32], [0.02, 0.5])
    mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ("walkers", "space"))

    def build(pair_path):
        engine = SpatialPackedEngine(spec, mesh2, rebuild_every=5,
                                     nested=True, pair_path=pair_path,
                                     interpret=True)
        cvs = [PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6,
                                  name="q6"),
               PackedCoordination(spec=spec, r0=nn * 1.35,
                                  r_cut=nn * 1.35 * 1.5, name="co")]

        def pack_one(w):
            r = np.random.default_rng(100 + w)
            vel = r.normal(0, 1.0, (n, 3)).astype(np.float32)
            vel -= vel.mean(axis=0)
            st, ovf = engine.pack_state(
                pos, box, np.zeros(n, np.int32),
                eps_i=np.ones(n, np.float32),
                sigma_i=np.ones(n, np.float32), vel=vel)
            assert not bool(ovf)
            return st

        states = jax.tree.map(lambda *xs: jnp.stack(xs),
                              *[pack_one(w) for w in range(2)])
        return WalkerSampler(
            system, states, engine, cvs=cvs, grid_spec=grid,
            hills=HillSpec.create(W=0.4, stride=25, mode=WELL_TEMPERED,
                                  deltaT=5.0),
            integrator_factory=lambda f: make_packed_langevin_step(
                f, dt=0.001, kT=0.7, gamma=1.0),
            seed=0, chunks_per_block=1, mesh=mesh2)

    s_p = build("triton")
    h_p = s_p.run(50)
    s_x = build("xla")
    h_x = s_x.run(50)

    assert int(s_p.bias.n_hills) == int(s_x.bias.n_hills) == 4
    np.testing.assert_allclose(np.asarray(h_p[-1]["cv"]),
                               np.asarray(h_x[-1]["cv"]),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_p.bias.grid.V),
                               np.asarray(s_x.bias.grid.V),
                               rtol=1e-3, atol=2e-5)
    assert not np.any(np.asarray(h_p[-1]["nlist_overflow"]))
