"""Per-type-PAIR interaction tables on the packed hot path.

Reference parity: HOOMD ``PotentialPair`` takes independent coefficients
per (type_i, type_j) (SURVEY.md §2b pair-potentials row) — in particular
ε_AB < √(ε_A·ε_B) drives χ-demixing in diblock melts (Configs 2/5).
Oracle: the particle-order all-pairs table engine (ops/pairs.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from metadyn_tpu.core.box import Box
from metadyn_tpu.ops.packed import (PackedSpec, pack, packed_lj_force,
                                    pair_scale_tables, unpack_positions)
from metadyn_tpu.ops.pairs import all_pairs_force, lj_tables, lj_kernel

EPS_T = np.array([[1.0, 0.35], [0.35, 0.8]])
SIG_T = np.array([[1.0, 1.05], [1.05, 1.2]])  # σ_AB ≠ (σ_A+σ_B)/2


def _case(with_sigma=True):
    rng = np.random.default_rng(0)
    n = 400
    L = 9.0
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    types = rng.integers(0, 2, n).astype(np.int32)
    es, ss, ed, sd = pair_scale_tables(EPS_T, SIG_T if with_sigma else None)
    spec = PackedSpec.create(
        L, n, r_cut=2.5, skin=0.4, cap=40, eps_scale=es, sigma_scale=ss)
    eps_i = ed[types]
    sigma_i = (sd if with_sigma else np.ones(2, np.float32))[types]
    st, ovf = pack(pos, Box.cubic(L), spec, jnp.asarray(types),
                   jnp.asarray(eps_i), jnp.asarray(sigma_i))
    assert not bool(ovf)
    return pos, types, L, spec, st


@pytest.mark.parametrize("with_sigma", [True, False],
                         ids=["eps+sigma", "eps-only"])
def test_packed_table_matches_particle_order(with_sigma):
    pos, types, L, spec, st = _case(with_sigma)
    n = pos.shape[0]
    params = lj_tables(2, epsilon=EPS_T,
                       sigma=SIG_T if with_sigma else 1.0,
                       r_cut=2.5, shift=True)
    ref = all_pairs_force(jnp.asarray(pos), jnp.asarray(types),
                          Box.cubic(L), lj_kernel, params)

    out = packed_lj_force(st, spec)
    np.testing.assert_allclose(float(out.potential_energy),
                               float(ref.energy), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out.virial),
                               np.asarray(ref.virial), rtol=1e-3)
    # forces: packed slot order → particle order via slot_of
    f_packed = np.asarray(out.f[:, st.slot_of].T)
    f_ref = np.asarray(ref.force)
    scale = np.abs(f_ref).max()
    np.testing.assert_allclose(f_packed, f_ref, rtol=1e-3,
                               atol=1e-4 * scale)


def test_packed_table_pallas2_matches_xla():
    """The Triton pair kernel (interpret) on the ε/σ pair table."""
    from metadyn_tpu.ops.packed_triton import packed_lj_force_triton

    pos, types, L, spec, st = _case(True)
    a = packed_lj_force(st, spec)
    b = packed_lj_force_triton(st, spec, interpret=True)
    np.testing.assert_allclose(float(a.potential_energy),
                               float(b.potential_energy), rtol=1e-4)
    scale = float(jnp.abs(a.f).max())
    np.testing.assert_allclose(np.asarray(b.f), np.asarray(a.f),
                               rtol=1e-3, atol=1e-3 * scale)
    np.testing.assert_allclose(np.asarray(b.virial), np.asarray(a.virial),
                               rtol=1e-3)


def test_scale_fn_bilinear_equals_one_hot():
    """The 2-type bilinear shortcut == explicit one-hot lookup (and a
    3-type table exercises the general path)."""
    from metadyn_tpu.ops.packed import _scale_fn
    k2 = _scale_fn(((1.0, 0.35), (0.35, 0.8)))
    for ti in (0.0, 1.0):
        for tj in (0.0, 1.0):
            want = [[1.0, 0.35], [0.35, 0.8]][int(ti)][int(tj)]
            got = float(k2(jnp.float32(ti), jnp.float32(tj)))
            assert abs(got - want) < 1e-6, (ti, tj, got)
    t3 = ((1.0, 0.5, 0.2), (0.5, 0.8, 0.6), (0.2, 0.6, 1.1))
    k3 = _scale_fn(t3)
    for a in range(3):
        for b in range(3):
            got = float(k3(jnp.float32(a), jnp.float32(b)))
            assert abs(got - t3[a][b]) < 1e-6
    # vacant sentinel type (out of range) yields 0 under one-hot
    assert float(k3(jnp.float32(3), jnp.float32(0))) == 0.0


def test_packed_table_with_fene_bonds():
    """Bonded diblock with ε_AB demixing: bonds keep FENE+WCA with the
    SCALED pair coefficients; forces stay finite and Newton-balanced."""
    from metadyn_tpu.ops.packed import bond_partner_attrs
    from tests.test_packed_bonds import _relaxed_melt

    pos, bonds, _ = _relaxed_melt(n_chains=12, chain_len=8)
    n = pos.shape[0]
    L = 12.0
    types = np.zeros(n, np.int32)
    types[n // 2:] = 1
    es, ss, ed, sd = pair_scale_tables(EPS_T, None)
    spec = PackedSpec.create(L, n, r_cut=2 ** (1 / 6), skin=0.4, cap=32,
                             fene_k=30.0, fene_r0=1.5, eps_scale=es)
    st, ovf = pack(pos, Box.cubic(L), spec, jnp.asarray(types),
                   jnp.asarray(ed[types]), jnp.ones(n),
                   extra_attrs=bond_partner_attrs(bonds, n))
    assert not bool(ovf)
    out = packed_lj_force(st, spec)
    f = np.asarray(out.f)
    assert np.isfinite(f).all()
    assert np.isfinite(float(out.potential_energy))
    # Newton: total force sums to ~0
    np.testing.assert_allclose(f.sum(axis=1), 0.0, atol=1e-2)


def test_eps_table_favors_demixing():
    """χ > 0 sanity: on identical liquid-like positions, A/B labels
    separated into half-boxes have LOWER energy than mixed labels when
    ε_AB < √(ε_A·ε_B) — the thermodynamic driving force Config-2/5's
    S(k) metadynamics now actually has."""
    from metadyn_tpu.utils.lattice import fcc_lattice

    a_lat = 1.65
    pos = fcc_lattice(6, a_lat)
    n = pos.shape[0]
    L = 6 * a_lat
    z = pos[:, 2]
    t_sep = (z > 0).astype(np.int32)                    # half-box split
    rng = np.random.default_rng(0)
    t_mix = rng.permutation(t_sep)                       # same composition
    eps_t = np.array([[1.0, 0.6], [0.6, 1.0]])
    es, _, ed, _ = pair_scale_tables(eps_t)

    def energy(types):
        spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.3, cap=48,
                                 eps_scale=es)
        st, ovf = pack(pos, Box.cubic(L), spec, jnp.asarray(types),
                       jnp.asarray(ed[types]), jnp.ones(n))
        assert not bool(ovf)
        return float(packed_lj_force(st, spec).potential_energy)

    e_sep, e_mix = energy(t_sep), energy(t_mix)
    assert e_sep < e_mix, (e_sep, e_mix)


@pytest.mark.parametrize("dd", ["1d", "2d"])
def test_pair_tables_under_spatial_dd(dd):
    """Per-type-pair tables under spatial DD: the ghost exchange must
    carry ``typ`` (round-4 fix: the halo-extended state used to zero it,
    so every cross-type table lookup at a shard boundary silently read
    row 0 — wrong ε/σ for a demixing melt).  Force/energy/virial parity
    vs the single-device table engine on both decompositions."""
    from jax.sharding import Mesh
    from metadyn_tpu.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu.parallel.spatial2d import SpatialPackedEngine2D

    rng = np.random.default_rng(3)
    n = 500
    L = 12.0                     # 4 cells per axis at r_list 3.0
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    types = rng.integers(0, 2, n).astype(np.int32)
    es, ss, ed, sd = pair_scale_tables(EPS_T, SIG_T)
    spec = PackedSpec.create(
        L, n, r_cut=2.5, skin=0.5, cap=40, eps_scale=es, sigma_scale=ss)
    eps_i = jnp.asarray(ed[types])
    sigma_i = jnp.asarray(sd[types])

    def pack_into(engine):
        st, ovf = engine.pack_state(pos, Box.cubic(L), jnp.asarray(types),
                                    eps_i=eps_i, sigma_i=sigma_i)
        assert not bool(ovf)
        return st

    from metadyn_tpu.core.packed_engine import PackedEngine
    ref_eng = PackedEngine(spec, pair_path="xla", with_energy=True)
    st_ref = pack_into(ref_eng)
    ref = ref_eng._force_e(st_ref, spec)

    if dd == "1d":
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
        eng = SpatialPackedEngine(spec, mesh, with_energy=True)
    else:
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("spacex", "spacey"))
        eng = SpatialPackedEngine2D(spec, mesh)
    st = pack_into(eng)
    out = jax.jit(lambda s: eng._force(s, spec))(st)

    np.testing.assert_allclose(float(out.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out.virial),
                               np.asarray(ref.virial), rtol=1e-4)
    f_dd = np.asarray(out.f[:, st.slot_of].T)
    f_ref = np.asarray(ref.f[:, st_ref.slot_of].T)
    scale = np.abs(f_ref).max()
    np.testing.assert_allclose(f_dd, f_ref, atol=2e-4 * scale)
