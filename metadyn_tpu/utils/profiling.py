"""Tracing / profiling helpers.

Reference parity: HOOMD's ``Profiler`` push/pop scopes and per-kernel
``Autotuner`` timing (SURVEY.md §5 tracing/profiling).  XLA autotunes
itself; what remains useful is (a) named phases visible in
TensorBoard/Perfetto traces, (b) wall-clock step-rate counters, and (c) a
one-call trace capture around any run segment.

Usage::

    from metadyn_tpu.utils.profiling import phase, StepTimer, trace

    with trace("/tmp/tb"):              # XLA/device trace → TensorBoard
        sampler.run(5000)

    timer = StepTimer(n_particles=n)
    hist = sampler.run(5000); timer.lap(5000)
    print(timer.report())               # steps/s + particle-steps/s

``phase`` is used inside jitted code (the samplers wrap their MD scan,
CV evaluation and deposit phases) and shows up as named regions in
profiler traces; it is a no-op for execution semantics.
"""
from __future__ import annotations

import contextlib
import time

import jax


def phase(name: str):
    """Named scope for jit-traced code (shows up in profiler traces)."""
    return jax.named_scope(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace around a code block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Wall-clock step-rate counter (the north-star metric,
    BASELINE.json:2: particle-steps/sec/chip)."""

    def __init__(self, n_particles: int):
        self.n = n_particles
        self.t0 = time.perf_counter()
        self.steps = 0
        self.laps: list[tuple[int, float]] = []

    def lap(self, n_steps: int) -> float:
        """Record a completed segment; returns its particle-steps/sec."""
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        self.steps += n_steps
        self.laps.append((n_steps, dt))
        return self.n * n_steps / dt

    def report(self) -> dict:
        tot_t = sum(d for _, d in self.laps)
        tot_s = sum(s for s, _ in self.laps)
        rate = tot_s / tot_t if tot_t else 0.0
        return {
            "steps": tot_s,
            "seconds": round(tot_t, 3),
            "steps_per_sec": round(rate, 1),
            "particle_steps_per_sec": round(rate * self.n, 1),
        }
