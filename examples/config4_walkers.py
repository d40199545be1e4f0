"""BASELINE Config 4: multiple walkers — 8 replicas sharded over the device
mesh, shared bias grid synchronized by psum each stride.

Each walker gets a device; on one device / CPU this runs with
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu.

Run: python examples/config4_walkers.py [--steps 100000]
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np

from metadyn_tpu.core.box import Box
from metadyn_tpu.core.state import make_state, make_system
from metadyn_tpu.core.forcefield import ForceField
from metadyn_tpu.integrate.langevin import make_langevin_step
from metadyn_tpu.cv.simple import AxisPosition
from metadyn_tpu.bias.grid import GridSpec
from metadyn_tpu.bias.metad import HillSpec, WELL_TEMPERED, free_energy
from metadyn_tpu.parallel.walkers import WalkerSampler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100_000)
    args = ap.parse_args()
    n_walkers = jax.device_count()
    print(f"{n_walkers} walkers on {jax.devices()}", flush=True)

    kT = 0.6

    def dw(pos, state, system):
        x = pos[0, 0]
        return 2.0 * (x * x - 1.0) ** 2 + 5.0 * (pos[0, 1] ** 2 + pos[0, 2] ** 2)

    system = make_system(1)
    ff = ForceField(external=dw)
    box = Box.cubic(50.0)
    starts = np.asarray([[1.0 - 2.0 * (w % 2), 0, 0] for w in range(n_walkers)],
                        np.float32)
    states = jax.vmap(lambda p: make_state(p[None, :], box))(jnp.asarray(starts))
    hills = HillSpec.create(W=0.1, stride=50, mode=WELL_TEMPERED, deltaT=6.0)
    grid = GridSpec.create([-1.6], [1.6], [161], [0.1])
    s = WalkerSampler(
        system, states, ff.bind(system), cvs=[AxisPosition(0, 0, name="x")],
        grid_spec=grid, hills=hills,
        integrator_factory=lambda f: make_langevin_step(
            f, system, dt=0.005, kT=kT, gamma=5.0),
        seed=0)
    s.run(args.steps)
    x = np.asarray(grid.axis_coords(0))
    F = np.asarray(free_energy(hills, s.bias, jnp.float32(kT)))
    F_true = 2.0 * (x ** 2 - 1.0) ** 2
    m = np.abs(x) <= 1.1
    err = (F - F_true)[m]
    err -= err.mean()
    print(f"hills={int(s.bias.n_hills)} (×{n_walkers} walkers/stride); "
          f"double-well FES max err = {np.abs(err).max():.3f} kT·({kT})")


if __name__ == "__main__":
    main()
