"""Integrators for the packed (slot-layout) state — SoA (3, Npad) math.

Same BAOAB/velocity-Verlet schemes as integrate/langevin.py, operating on
the packed hot-path layout (ops/packed.py).  Vacant slots integrate harmless
zeros (ε=0 ⇒ zero force; noise on vacant slots never couples to physics).
Uniform particle mass for now (all baseline configs are unit-mass).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..ops.packed import PackedState, PackedSpec, VACANT_THR, VACANT_X

PackedStepFn = Callable[[PackedState, jax.Array], PackedState]


def _pin_vacant(r_new: jax.Array, r_old: jax.Array) -> jax.Array:
    """Pin vacant slots at the EXACT coordinate sentinel across the step.

    In uniform-eps mode (ops/packed.py) vacant slots sit at VACANT_X; the
    pair paths cull them purely by the r² tests (r²==0 exactly for
    sentinel–sentinel pairs, r²≥L² for image-shifted ones, r²~1e14 for
    vacant–real) — see ops/packed_triton._pair_terms.  That invariant requires
    vacant slots NOT to drift under the Langevin noise kick, so every
    integrator re-pins them each step (no-op in non-uniform mode, where no
    coordinate exceeds VACANT_THR).  This also keeps vacant slots from
    spuriously tripping the half-skin repack trigger.
    """
    return jnp.where(r_old > VACANT_THR, jnp.float32(VACANT_X), r_new)


# NOTE: packed integrators do NOT wrap per step.  Wrapping teleports a
# coordinate by ±L while the slot cell still implies the old side, making
# the particle a ghost to every neighbor until the next repack (observed:
# rare deep pair overlaps at the box faces → explosions).  Positions drift
# continuously (≤ half-skin outside the box at most) and ops/packed.repack*
# wraps atomically with the slot migration.


def make_packed_langevin_step(
    force_fn: Callable[[PackedState], PackedState],
    dt: float, kT: float, gamma: float = 1.0, mass: float = 1.0,
) -> PackedStepFn:
    """BAOAB Langevin on packed state (cf. integrate/langevin.py).

    ``force_fn`` may return either the state (normal) or a
    ``(state, extras)`` tuple — then ``step`` returns ``(state, extras)``
    too.  The rich form lets the fused MTS kernel thread fresh CV terms
    out of the trailing force call (sampler.make_stride_chunk lag path)
    without a second traversal; the choice is trace-time static."""
    c1 = jnp.exp(-gamma * dt)
    c2 = jnp.sqrt((1.0 - c1 * c1) * kT / mass)

    def step(state: PackedState, key: jax.Array) -> PackedState:
        v = state.v + (0.5 * dt / mass) * state.f
        r = state.r + 0.5 * dt * v
        noise = jax.random.normal(key, v.shape, v.dtype)
        v = c1 * v + c2 * noise
        r = r + 0.5 * dt * v
        out = force_fn(state.replace(r=_pin_vacant(r, state.r)))
        if isinstance(out, tuple):
            state, extras = out
            return state.replace(v=v + (0.5 * dt / mass) * state.f), extras
        state = out
        return state.replace(v=v + (0.5 * dt / mass) * state.f)

    return step


def make_packed_nve_step(
    force_fn: Callable[[PackedState], PackedState],
    dt: float, mass: float = 1.0,
) -> PackedStepFn:
    def step(state: PackedState, key: jax.Array) -> PackedState:
        v_half = state.v + (0.5 * dt / mass) * state.f
        r = _pin_vacant(state.r + dt * v_half, state.r)
        state = force_fn(state.replace(r=r))
        return state.replace(v=v_half + (0.5 * dt / mass) * state.f)

    return step


def make_packed_npt_scr_step(
    force_fn: Callable[[PackedState], PackedState],
    spec: PackedSpec,
    dt: float, kT: float, pressure: float,
    gamma: float = 1.0, tau_p: float = 2.0,
    anisotropic: bool = False,
    box_bias_fn=None,
    kappa: float = 0.1, mass: float = 1.0,
    engine=None,
) -> PackedStepFn:
    """BAOAB Langevin + stochastic-cell-rescaling barostat on the packed
    hot path (cf. integrate/npt.py — same Bernetti–Bussi SCR scheme).

    The packed layout survives rescaling for free: the r→cell mapping is
    fractional (``_cell_id_packed`` divides by the live box.L), and both
    coordinates and box scale together, so slot↔cell assignments are
    scale-invariant.  ``ref_r`` is rescaled too, keeping the half-skin
    repack trigger a pure drift measure.  The ENGINE must run
    ``with_energy=True``: the barostat reads state.virial every step
    (VERDICT r2 missing #4 — reference NPT runs on the production
    engine, SURVEY.md §2b IntegratorTwoStep row).

    Caveat (static cell grid): the cell COUNT per axis is compile-time
    fixed while the cell width L/c tracks the box, so a large net
    compression can push the cell width below r_cut+skin.  Guarded by a
    ``nlist_stale``-style check folded into the metrics via the repack
    criterion; size the grid with headroom for the expected density.

    Pass the ``engine`` the ``force_fn`` came from to get a LOUD check
    that its inner force path produces a live per-step virial: the
    Triton pair kernel without ``with_energy`` skips the virial, and a
    barostat silently
    integrating against zero virial expands the box into vacuum
    (round-4 advisor).  The CLI always passes it.
    """
    if engine is not None:
        assert getattr(engine, "virial_live", True), (
            "make_packed_npt_scr_step: this engine's inner force path "
            "skips the energy/virial accumulation (Pallas forces-only "
            "kernel), so the barostat would read virial=0 every step. "
            "Construct the engine with with_energy=True.")
    c1 = jnp.exp(-gamma * dt)
    c2 = jnp.sqrt((1.0 - c1 * c1) * kT / mass)

    def step(state: PackedState, key: jax.Array) -> PackedState:
        assert state.box.tilt is None, (
            "packed NPT/SCR supports orthorhombic boxes: the per-axis "
            "Cartesian rescale does not commute with tilt factors "
            "(HOOMD's NPT couples tilt DOFs separately — out of scope)")
        k_noise, k_baro = jax.random.split(key)
        valid = (state.pid < spec.n_real).astype(jnp.float32)[None, :]
        # --- BAOAB on particles ---
        v = state.v + (0.5 * dt / mass) * state.f
        r = state.r + 0.5 * dt * v
        noise = jax.random.normal(k_noise, v.shape, v.dtype)
        v = c1 * v + c2 * noise
        r = r + 0.5 * dt * v

        # --- barostat: stochastic cell rescaling ---
        ke2_d = mass * jnp.sum(v * v * valid, axis=1)       # (3,) Σ m v_d²
        vol = state.box.volume
        st_mid = state.replace(r=r)
        if anisotropic:
            g = jax.random.normal(k_baro, (3,))
            p_d = (ke2_d + state.virial) / vol
            dP = p_d - pressure
            if box_bias_fn is not None:
                dVdL = box_bias_fn(st_mid)
                dP = dP - dVdL * state.box.L / vol
            eps = (-(kappa * dt / (3.0 * tau_p)) * (-dP)
                   + jnp.sqrt(2.0 * kT * kappa * dt
                              / (3.0 * vol * tau_p)) * g)
        else:
            g = jax.random.normal(k_baro, ())
            p_int = (jnp.sum(ke2_d) / 3.0 + jnp.sum(state.virial) / 3.0) / vol
            eps = (-(kappa * dt / tau_p) * (pressure - p_int)
                   + jnp.sqrt(2.0 * kT * kappa * dt / (vol * tau_p)) * g) / 3.0
        scale = jnp.exp(eps)                                 # (3,) or scalar
        scale3 = jnp.broadcast_to(scale, (3,))[:, None]
        new_box = state.box.replace(L=state.box.L * jnp.broadcast_to(scale, (3,)))
        r = r * scale3
        v = v / scale3
        ref_r = state.ref_r * scale3
        if spec.uniform_eps is not None:
            # keep vacant slots pinned at the coordinate sentinel (the
            # rescale would slowly walk them across VACANT_THR otherwise)
            from ..ops.packed import VACANT_X
            r = jnp.where(valid > 0, r, jnp.float32(VACANT_X))
            ref_r = jnp.where(valid > 0, ref_r, jnp.float32(VACANT_X))
        state = force_fn(state.replace(r=r, ref_r=ref_r, box=new_box))
        return state.replace(v=v + (0.5 * dt / mass) * state.f)

    return step
