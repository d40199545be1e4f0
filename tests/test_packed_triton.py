"""The Triton pair kernel's wrapper (ops/packed_triton.py) on the CPU:
the neighbour-cell tables, padding and block sizes, energy/virial with a
cell mask, triclinic boxes, sparse occupancy, and the choice of pair path.
The kernel runs through the Pallas interpreter; the XLA roll sweep
(``packed_lj_force``) is the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metadyn_tpu.core.box import Box
from metadyn_tpu.core.packed_engine import PackedEngine
from metadyn_tpu.ops.packed import (PackedSpec, pack, packed_lj_force,
                                    _roll_offsets)
from metadyn_tpu.ops.packed_triton import (choose_pair_path, neighbor_cells,
                                           packed_lj_force_triton)


def _kernel(st, spec, **kw):
    return packed_lj_force_triton(st, spec, interpret=True, **kw)


def _random_case(n=300, L=9.0, cap=24, seed=0, tilt=None, **kw):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    # keep a minimum spacing so no pair is in the r^-12 blow-up regime
    keep = [0]
    for i in range(1, n):
        d = pos[keep] - pos[i]
        d -= L * np.round(d / L)
        if (d * d).sum(-1).min() > 0.8 ** 2:
            keep.append(i)
    pos = pos[keep]
    n = pos.shape[0]
    box = Box.cubic(L) if tilt is None else Box(
        L=np.full(3, L, np.float32), tilt=np.asarray(tilt, np.float32))
    spec = PackedSpec.create(L, n, r_cut=2.2, skin=0.3, cap=cap, tilt=tilt,
                             **kw)
    st, ovf = pack(pos, box, spec, jnp.zeros(n, jnp.int32), jnp.ones(n),
                   jnp.ones(n))
    assert not bool(ovf)
    return spec, st


def _assert_matches(a, b, energy=True):
    scale = float(jnp.abs(a.f).max())
    np.testing.assert_allclose(np.asarray(b.f), np.asarray(a.f),
                               rtol=1e-4, atol=1e-5 * scale)
    if energy:
        # f32 sums of terms of both signs: absolute floor for a small total
        np.testing.assert_allclose(float(b.potential_energy),
                                   float(a.potential_energy), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(b.virial),
                                   np.asarray(a.virial), rtol=1e-4)


@pytest.mark.parametrize("dims", [(3, 3, 3), (4, 5, 3), (3, 4, 6)])
def test_neighbor_cells_match_roll(dims):
    """Row o of the neighbour table is the cell the XLA sweep's roll by
    offset o brings to each cell, and the wrap counts are its shifts."""
    nb, ush = neighbor_cells(dims)
    C = int(np.prod(dims))
    ids = np.arange(C).reshape(dims)
    spec = PackedSpec(cells_per_dim=dims, cap=1, n_real=1, r_cut=1.0,
                      skin=0.1)
    for o, ((ox, oy, oz), ushift) in enumerate(_roll_offsets(spec)):
        rolled = np.roll(ids, shift=(-ox, -oy, -oz), axis=(0, 1, 2))
        np.testing.assert_array_equal(nb[o], rolled.reshape(-1))
        np.testing.assert_array_equal(ush[o], ushift)
    assert nb.dtype == np.int32 and ush.shape == (27, 3, C)


@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_kernel_block_padding(block):
    """Any power-of-two block: the slot axis is padded to a whole number
    of blocks with vacant lanes, and the result is sliced back."""
    spec, st = _random_case(cap=20)
    assert spec.n_pad % block != 0 or block == 16
    a = packed_lj_force(st, spec)
    b = _kernel(st, spec, block=block)
    assert b.f.shape == a.f.shape
    _assert_matches(a, b)


def test_kernel_rejects_non_power_of_two_block():
    spec, st = _random_case(n=60, cap=20)
    with pytest.raises(AssertionError, match="powers of two"):
        _kernel(st, spec, block=48)


def test_kernel_cell_mask_energy():
    """cell_mask restricts the energy/virial sums to masked-in i-cells
    exactly as the XLA path does (the DD islands' ghost planes); the
    forces are unmasked."""
    spec, st = _random_case()
    mask = jnp.asarray(
        (np.arange(spec.n_cells) % 3 != 0).astype(np.float32))
    a = packed_lj_force(st, spec, cell_mask=mask)
    b = _kernel(st, spec, cell_mask=mask)
    _assert_matches(a, b)
    full = _kernel(st, spec)
    assert float(full.potential_energy) != float(b.potential_energy)


def test_kernel_triclinic_matches_xla():
    """Tilted box: the neighbour shifts go through shift_rows_cart."""
    spec, st = _random_case(L=10.0, tilt=(0.2, -0.1, 0.15))
    _assert_matches(packed_lj_force(st, spec), _kernel(st, spec))


def test_kernel_sparse_occupancy():
    """Mostly-empty cells: whole blocks without an occupied slot skip the
    sweep and the rank loop stops at the neighbours' occupancy, with no
    change to the forces."""
    spec, st = _random_case(n=25, L=10.0, cap=12, uniform_sigma=1.0,
                            uniform_eps=1.0)
    occ = np.asarray((st.pid < spec.n_real).reshape(spec.cap, -1)).sum(0)
    assert (occ == 0).any() and occ.max() < spec.cap
    _assert_matches(packed_lj_force(st, spec), _kernel(st, spec))


def test_kernel_force_only_keeps_scalars():
    """with_energy=False computes forces only and leaves the state's
    energy and virial as they were."""
    spec, st = _random_case()
    st = st.replace(potential_energy=jnp.float32(7.0),
                    virial=jnp.asarray([1.0, 2.0, 3.0], jnp.float32))
    b = _kernel(st, spec, with_energy=False)
    _assert_matches(packed_lj_force(st, spec), b, energy=False)
    assert float(b.potential_energy) == 7.0
    np.testing.assert_array_equal(np.asarray(b.virial), [1.0, 2.0, 3.0])


@pytest.mark.parametrize("kind,path,want", [
    ("lj", None, "xla"),            # the CPU default
    ("lj", "triton", "triton"),
    ("lj", "xla", "xla"),
    ("soft", None, "xla"),
    ("soft", "triton", ValueError),
    ("lj", "pallas", ValueError),
])
def test_choose_pair_path(kind, path, want):
    spec = PackedSpec(cells_per_dim=(3, 3, 3), cap=4, n_real=8, r_cut=1.0,
                      skin=0.1, pair_kind=kind)
    if want is ValueError:
        with pytest.raises(ValueError):
            choose_pair_path(spec, path)
    else:
        assert choose_pair_path(spec, path) == want


@pytest.mark.parametrize("path,with_energy,live", [
    ("xla", False, True), ("triton", False, False), ("triton", True, True)])
def test_engine_energy_live_flag(path, with_energy, live):
    """The kernel skips energy/virial on inner steps unless with_energy;
    per-step consumers (SCR-NPT, the WTE CV) read this flag."""
    spec, st = _random_case(n=60, cap=20)
    eng = PackedEngine(spec, pair_path=path, with_energy=with_energy,
                       interpret=True)
    assert eng.pair_path == path
    assert eng.energy_live is live and eng.virial_live is live
    st2, _ = eng.init(st)
    _assert_matches(packed_lj_force(st, spec), st2, energy=live)


@pytest.mark.gpu
def test_triton_kernel_compiles_on_gpu():
    """Compiled (not interpreted) kernel vs the XLA sweep — GPU only;
    chip_smoke.py runs the same comparison at full size."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernel has no CPU backend")
    spec, st = _random_case()
    _assert_matches(packed_lj_force(st, spec),
                    jax.jit(lambda s: packed_lj_force_triton(s, spec))(st))
