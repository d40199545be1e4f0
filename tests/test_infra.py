"""Infrastructure: the compile-cache policy, the pytree dataclass helper,
the lamellar CV's full-precision phase, and chip_smoke.py's refusal to
run without a GPU."""
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metadyn_tpu.utils import cache, struct

ROOT = pathlib.Path(__file__).resolve().parents[1]


# --- compile cache -----------------------------------------------------------

@pytest.mark.parametrize("backend,env,want", [
    ("gpu", {cache.ENV: "/some/dir"}, "/some/dir"),
    ("cpu", {cache.ENV: "/some/dir"}, "/some/dir"),
    ("gpu", {}, str(ROOT / ".jax_cache")),
    ("cpu", {}, None),
])
def test_cache_dir_policy(backend, env, want):
    """JAX_COMPILATION_CACHE_DIR is used as is; unset, the GPU caches in
    <repo>/.jax_cache (a fixed path) and the CPU not at all."""
    assert cache.cache_dir(backend, env) == want


def test_cache_enable_on_cpu_sets_no_dir():
    assert os.environ.get(cache.ENV) or (
        cache.enable_persistent_cache() is None)
    if not os.environ.get(cache.ENV):
        assert jax.config.jax_compilation_cache_dir is None


# --- struct ------------------------------------------------------------------

@struct.dataclass
class _Thing:
    a: jax.Array
    b: jax.Array = struct.field(default_factory=lambda: jnp.zeros(2))
    n: int = struct.field(pytree_node=False, default=3)
    tag: str = struct.field(pytree_node=False, default="x")


def test_struct_pytree_roundtrip():
    t = _Thing(a=jnp.ones(3))
    leaves, tree = jax.tree.flatten(t)
    assert len(leaves) == 2                     # a, b — not the static ones
    t2 = jax.tree.unflatten(tree, leaves)
    assert t2.n == 3 and t2.tag == "x"
    np.testing.assert_array_equal(np.asarray(t2.a), np.ones(3))
    doubled = jax.tree.map(lambda x: 2 * x, t)
    np.testing.assert_array_equal(np.asarray(doubled.a), 2 * np.ones(3))


def test_struct_static_fields_are_trace_constants():
    """pytree_node=False fields live in the treedef: jit retraces on a
    change and sees a Python value inside the trace."""
    traces = []

    @jax.jit
    def f(t):
        traces.append(t.n)
        return t.a * t.n

    t = _Thing(a=jnp.ones(2))
    np.testing.assert_array_equal(np.asarray(f(t)), [3.0, 3.0])
    f(t.replace(a=jnp.zeros(2)))
    assert traces == [3]                        # same structure: cached
    np.testing.assert_array_equal(np.asarray(f(t.replace(n=5))), [5.0, 5.0])
    assert traces == [3, 5]


def test_struct_replace_and_frozen():
    t = _Thing(a=jnp.ones(2))
    t2 = t.replace(tag="y")
    assert t.tag == "x" and t2.tag == "y" and t2.a is t.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.n = 4


# --- lamellar CV precision ---------------------------------------------------

@pytest.mark.parametrize("tilt", [None, (0.3, -0.2, 0.1)],
                         ids=["ortho", "triclinic"])
def test_lamellar_phase_matches_f64(tilt):
    """The lamellar order parameter against an f64 NumPy evaluation: the
    k·r products run at full f32 precision (a default-precision matmul
    runs in TF32 on the GPU, ~1e-3 relative error in the phase)."""
    from metadyn_tpu.core.box import Box, h_inverse
    from metadyn_tpu.core.state import make_state, make_system
    from metadyn_tpu.cv.lamellar import LamellarOP

    rng = np.random.default_rng(2)
    n, L = 500, 12.0
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    types = rng.integers(0, 2, n)
    box = (Box.cubic(L) if tilt is None else
           Box(L=np.full(3, L, np.float32), tilt=np.asarray(tilt, np.float32)))
    lv = np.array([[0, 0, 3], [1, 2, 0], [2, -1, 1]])
    ph = np.array([0.3, -0.7, 1.1])
    cv = LamellarOP.create(mode=[1.0, -0.5], lattice_vectors=lv, phases=ph)
    state = make_state(pos, box)
    got = float(cv.value(state, make_system(n, types=types)))

    p = np.asarray(state.pos, np.float64)
    hinv = np.asarray(h_inverse(box), np.float64)
    k = 2.0 * np.pi * lv @ hinv
    want = np.mean(np.asarray([1.0, -0.5])[types][:, None]
                   * np.cos(p @ k.T + ph[None, :])) * lv.shape[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --- chip_smoke.py -----------------------------------------------------------

def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu():
    r = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
