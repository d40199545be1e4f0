"""Simple CVs: single-particle coordinate (test oracle) and energy wrapper.

``EnergyCV`` is the parity equivalent of ``CollectiveWrapper`` +
``WellTemperedEnsemble`` (recalled, SURVEY.md §2a): any potential-energy
function becomes a CV, and biasing the total potential energy is the
well-tempered-ensemble method of Bonomi–Parrinello.  In JAX this is free —
the CV *is* the energy function and forces come from the shared vjp.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.state import State, System


@struct.dataclass
class AxisPosition:
    """s = unwrapped coordinate ``axis`` of particle ``particle``.

    The 1-particle metadynamics oracle CV (SURVEY.md §4.4).
    """

    particle: int = struct.field(pytree_node=False, default=0)
    axis: int = struct.field(pytree_node=False, default=0)
    name: str = struct.field(pytree_node=False, default="x")

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> jax.Array:
        # unwrapped so the CV is smooth across the periodic boundary
        return (
            state.pos[self.particle, self.axis]
            + state.image[self.particle, self.axis].astype(state.pos.dtype)
            * state.box.L[self.axis]
        )


@struct.dataclass
class EnergyCV:
    """s = U(state) for an arbitrary energy function — the CollectiveWrapper.

    ``energy_fn(pos, state, system) -> scalar``; differentiating through it
    gives bias forces = bias · F_wrapped exactly as the reference applies.
    """

    energy_fn: Callable = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="energy")

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> jax.Array:
        return self.energy_fn(state.pos, state, system)


@struct.dataclass
class PotentialEnergyCV:
    """s = total potential energy from the live force pass — the
    well-tempered-ensemble CV (reference ``WellTemperedEnsemble``,
    SURVEY.md §2a) on ANY engine.

    Reads ``state.potential_energy`` and applies the analytic bias force
    ``dU/dr = −F  ⇒  f_bias = +dVds·F`` (no vjp), so it works on both the
    particle-order ``State`` (``.force``) and the packed SoA state
    (``.f``).  Requirements: the engine must refresh the energy every
    inner step (``PackedEngine(with_energy=True)``; the particle-order
    engines always do), and — because the stored scalar is not
    differentiable w.r.t. positions — every co-registered CV must also
    provide ``accum_bias_force`` so the sampler stays on the analytic
    path (the CLI enforces this).
    """

    name: str = struct.field(pytree_node=False, default="U")

    # sampler loud-check marker: this CV reads state.potential_energy
    # between stride boundaries, so the engine must refresh it per step
    needs_live_energy = True

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state, system: System) -> jax.Array:
        return state.potential_energy

    def accum_bias_force(self, state, system, dVds: jax.Array,
                         f_acc: jax.Array) -> jax.Array:
        f = state.f if hasattr(state, "f") else state.force
        return f_acc + dVds * f
