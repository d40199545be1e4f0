#!/usr/bin/env python
"""Hill-deposit latency microbenchmark (BASELINE.json:2 tracked metric).

Measures the marginal cost of a metadynamics hill deposit on the 64k
headline system by differencing two samplers that run the IDENTICAL fused
stride chunk — one depositing a hill every stride (add_hills=True), one
frozen-bias (add_hills=False) — at a short stride so the deposit is a
measurable fraction of a block.  Also reports the max/median spread of
deposit-bearing block times: the deposit is fused into the stride scan
(SURVEY.md §7 tenet 1), so there must be NO step-time spike at stride
boundaries, unlike the reference's host-side full-grid update + file
append every stride (SURVEY.md §3.1).

Prints one JSON line:
  {"deposit_us": ..., "block_ms_median": ..., "block_ms_max": ...,
   "spike_ratio": ...}

Not part of bench.py's headline run.
"""
import json
import sys
import time

import jax

from metadyn_tpu.utils.cache import enable_persistent_cache
enable_persistent_cache()

import numpy as np

from metadyn_tpu.core.box import Box
from metadyn_tpu.core.state import make_system
from metadyn_tpu.core.packed_engine import PackedEngine
from metadyn_tpu.ops.packed import PackedSpec
from metadyn_tpu.integrate.packed import make_packed_langevin_step
from metadyn_tpu.cv.packed import PackedLamellar
from metadyn_tpu.bias.grid import GridSpec
from metadyn_tpu.bias.metad import HillSpec, WallSpec, WELL_TEMPERED
from metadyn_tpu.sampler import MetadSampler

from bench import KT, load_liquid

STRIDE = 10           # dense deposits: 50 per timed dispatch
CHUNKS = 50
N_BLOCKS = 20


def build(add_hills, state, system, engine, cvs, gspec):
    return MetadSampler(
        system, state, engine, cvs=cvs, grid_spec=gspec,
        hills=HillSpec.create(W=0.1, stride=STRIDE, mode=WELL_TEMPERED,
                              deltaT=5.0),
        integrator_factory=lambda f: make_packed_langevin_step(
            f, dt=0.005, kT=KT, gamma=1.0),
        seed=0, bias_every=5, chunks_per_block=CHUNKS, add_hills=add_hills,
        walls=WallSpec.at_grid_edges(gspec, k=2000.0),
    )


def time_blocks(sampler):
    sampler.run(STRIDE * CHUNKS)                  # compile + settle
    ts = []
    for _ in range(N_BLOCKS):
        t0 = time.time()
        sampler.run(STRIDE * CHUNKS)      # returns host metrics: synced
        ts.append(time.time() - t0)
    return np.array(ts)


def main():
    liq_pos, liq_vel, L = load_liquid()
    n = liq_pos.shape[0]
    box = Box.cubic(L)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    system = make_system(n)
    cv1 = PackedLamellar.create([[0, 0, 3]], n_real=n, name="a")
    cv2 = PackedLamellar.create([[0, 3, 0]], n_real=n, name="b")
    amps = np.ones(n, np.float32)
    gspec = GridSpec.create([-0.06, -0.06], [0.06, 0.06], [64, 64],
                            [0.004, 0.004])

    def fresh_state(engine):
        st, ovf = engine.pack_state(
            liq_pos, box, np.zeros(n, np.int32),
            eps_i=np.ones(n, np.float32), sigma_i=np.ones(n, np.float32),
            vel=liq_vel,
            extra_attrs={cv1.attr_name: amps, cv2.attr_name: amps})
        assert not bool(ovf)
        return st

    engine = PackedEngine(spec, rebuild_every=10)
    t_dep = time_blocks(build(True, fresh_state(engine), system, engine,
                              [cv1, cv2], gspec))
    t_frz = time_blocks(build(False, fresh_state(engine), system, engine,
                              [cv1, cv2], gspec))

    med_dep, med_frz = float(np.median(t_dep)), float(np.median(t_frz))
    out = {
        "deposit_us": round((med_dep - med_frz) / CHUNKS * 1e6, 2),
        "block_ms_median": round(med_dep * 1e3, 3),
        "block_ms_max": round(float(t_dep.max()) * 1e3, 3),
        "spike_ratio": round(float(t_dep.max()) / med_dep, 3),
        "stride": STRIDE,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
