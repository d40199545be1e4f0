#!/usr/bin/env python
"""Honest Config-3 datapoint (BASELINE.json:9): 64k LJ particles with the
LITERAL config — Steinhardt Q6 + coordination CVs on a 2-D well-tempered
grid — reported alongside bench.py's headline number (VERDICT r1 item 10).

The order-CV sweeps dominate: per MTS sub-chunk the bias force
evaluates both CVs and their analytic gradients over the cell-pair
structure (two fused XLA roll-sweep traversals, cv/packed_order.py).

Cell-grid tuning: skin 0.3 → 14³ cells, measured max occupancy exactly
32 (fcc-commensurate cells), cap 32.  If the cap-32 run trips the
overflow guard (a different seed CAN exceed 32), the bench re-runs once
with cap=36 and reports THAT number instead of failing.

``--dd`` runs the same workload through the spatial-DD engine on a
1-device ``("space",)`` mesh: all the halo machinery executes with zero
real communication, so (single-device rate − this) is the decomposition
overhead.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} where
vs_baseline is against the same 50M north star for context (the north
star itself is defined on the 2-CV lamellar bench, BASELINE.json:2,5).
"""
import argparse
import json
import sys
import time

import jax

from metadyn_tpu.utils.cache import enable_persistent_cache
enable_persistent_cache()

import jax.numpy as jnp
import numpy as np

from metadyn_tpu.core.box import Box
from metadyn_tpu.core.state import make_system
from metadyn_tpu.core.packed_engine import PackedEngine
from metadyn_tpu.ops.packed import PackedSpec
from metadyn_tpu.integrate.packed import make_packed_langevin_step
from metadyn_tpu.cv.packed_order import PackedSteinhardtQl, PackedCoordination
from metadyn_tpu.bias.grid import GridSpec
from metadyn_tpu.bias.metad import HillSpec, WallSpec, WELL_TEMPERED
from metadyn_tpu.sampler import MetadSampler
from metadyn_tpu.utils.lattice import fcc_lattice

BASELINE = 50e6


def run_once(cap: int, dd: bool = False):
    """One measured bench pass at the given cell capacity.

    Returns (rates, ok) — ok=False when the run-validity guard trips
    (overflow/NaN), in which case the rates are meaningless."""
    rho = 0.95                         # supercooled: nucleation regime
    a = (4.0 / rho) ** (1.0 / 3.0)
    n_cells = 25
    pos = fcc_lattice(n_cells, a)
    n = pos.shape[0]
    L = n_cells * a
    box = Box.cubic(L)
    kT = 0.6
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.3, cap=cap,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    if dd:
        from jax.sharding import Mesh
        from metadyn_tpu.parallel.spatial import SpatialPackedEngine
        mesh = Mesh(np.asarray(jax.devices()[:1]), ("space",))
        engine = SpatialPackedEngine(spec, mesh, rebuild_every=10)
    else:
        engine = PackedEngine(spec, rebuild_every=10)
    system = make_system(n)
    rng = np.random.default_rng(0)
    vel = rng.normal(0.0, np.sqrt(kT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    state, overflow = engine.pack_state(
        pos, box, jnp.zeros(n, jnp.int32),
        eps_i=jnp.ones(n), sigma_i=jnp.ones(n), vel=vel)
    if bool(overflow):
        return [], False

    nn = a / np.sqrt(2)
    q6 = PackedSteinhardtQl(spec=spec, r_cut=nn * 1.2, l=6, name="q6")
    co = PackedCoordination(spec=spec, r0=nn * 1.35, name="coord",
                            r_cut=nn * 1.35 * 1.5)
    grid = GridSpec.create([0.0, 4.0], [0.7, 28.0], [48, 48], [0.015, 0.5])
    stride = 100
    sampler = MetadSampler(
        system, state, engine, cvs=[q6, co], grid_spec=grid,
        hills=HillSpec.create(W=0.4, stride=stride, mode=WELL_TEMPERED,
                              deltaT=6.0),
        integrator_factory=lambda f: make_packed_langevin_step(
            f, dt=0.004, kT=kT, gamma=1.0),
        seed=0, chunks_per_block=2,
        walls=WallSpec.at_grid_edges(grid, k=200.0),
        # bias-force MTS: the global 64k-atom CVs drift negligibly over
        # 10 steps (≪ hill σ) — the PLUMED MULTIPLE_TIME_STEP idea
        bias_every=10)

    sampler.run(stride * 2)            # compile + settle
    n_meas = stride * 4
    rates, ok = [], True
    for _ in range(2):
        t0 = time.time()
        hist = sampler.run(n_meas)
        rates.append(n * n_meas / (time.time() - t0))
        m = hist[-1]
        ok = ok and (np.isfinite(m["potential_energy"])
                     and np.isfinite(m["cv"]).all()
                     and not bool(m["nlist_overflow"]))
    return rates, ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dd", action="store_true",
                    help="run through SpatialPackedEngine on a 1-device "
                    "mesh (the decomposition-overhead probe)")
    args = ap.parse_args()
    rates, ok = run_once(cap=32, dd=args.dd)
    if not ok:
        # occupancy cliff: retry once with headroom (see docstring)
        rates, ok = run_once(cap=36, dd=args.dd)
    if not ok:
        print(json.dumps({"metric": "config3_q6_coord_particle_steps_per_sec",
                          "value": 0.0, "unit": "particle-steps/s",
                          "vs_baseline": 0.0, "error": "run invalid"}))
        return 1
    rate = float(np.mean(rates))
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "config3_q6_coord_particle_steps_per_sec",
        "value": rate,
        "blocks": rates,
        "unit": "particle-steps/s",
        "vs_baseline": rate / BASELINE,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
