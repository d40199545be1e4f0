"""Particle state pytree — the JAX equivalent of HOOMD's ParticleData.

Reference parity: HOOMD-blue ``ParticleData`` / ``SystemDefinition``
(positions, velocities, types, images, masses, charges, box) — SURVEY.md §2b.
Everything is a fixed-shape f32/i32 array so the whole state is a single
donatable pytree flowing through one jitted step.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from .box import Box, wrap


@struct.dataclass
class State:
    """Dynamic per-particle state carried through the MD loop.

    Forces from the previous step are carried so velocity-Verlet-style
    integrators do exactly one force evaluation per step.
    """

    pos: jax.Array       # (N, 3) f32 — wrapped into the box
    vel: jax.Array       # (N, 3) f32
    force: jax.Array     # (N, 3) f32 — forces at current positions
    image: jax.Array     # (N, 3) i32 — box-image counters (unwrapping / MSD)
    box: Box
    potential_energy: jax.Array  # () f32 — potential energy at current positions
    virial: jax.Array            # (3,) f32 — diagonal virial Σ_{i<j} f_ij,d·r_ij,d
    xi: jax.Array                # () f32 — Nosé–Hoover thermostat DOF

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def unwrapped_pos(self) -> jax.Array:
        return self.pos + self.image.astype(self.pos.dtype) * self.box.L


@struct.dataclass
class System:
    """Static (per-run constant) particle attributes + topology.

    Split out of :class:`State` so the integrator carry stays minimal and
    XLA can treat these as loop invariants.
    """

    types: jax.Array     # (N,) i32 — particle type ids
    mass: jax.Array      # (N,) f32
    charge: jax.Array    # (N,) f32
    bonds: jax.Array     # (B, 2) i32 — bond table (empty (0,2) if none)
    bond_types: jax.Array  # (B,) i32
    n_types: int = struct.field(pytree_node=False, default=1)

    @property
    def n(self) -> int:
        return self.types.shape[0]


def make_system(
    n: int,
    types: Optional[np.ndarray] = None,
    mass: Optional[np.ndarray] = None,
    charge: Optional[np.ndarray] = None,
    bonds: Optional[np.ndarray] = None,
    bond_types: Optional[np.ndarray] = None,
    n_types: Optional[int] = None,
) -> System:
    types = np.zeros(n, np.int32) if types is None else np.asarray(types, np.int32)
    mass = np.ones(n, np.float32) if mass is None else np.asarray(mass, np.float32)
    charge = np.zeros(n, np.float32) if charge is None else np.asarray(charge, np.float32)
    bonds = np.zeros((0, 2), np.int32) if bonds is None else np.asarray(bonds, np.int32)
    bond_types = (
        np.zeros(bonds.shape[0], np.int32) if bond_types is None
        else np.asarray(bond_types, np.int32)
    )
    if n_types is None:
        n_types = int(types.max()) + 1 if n else 1
    return System(
        types=jnp.asarray(types), mass=jnp.asarray(mass), charge=jnp.asarray(charge),
        bonds=jnp.asarray(bonds), bond_types=jnp.asarray(bond_types), n_types=n_types,
    )


def make_state(
    pos: np.ndarray,
    box: Box,
    vel: Optional[np.ndarray] = None,
) -> State:
    """Build an initial State; positions are wrapped, images start at 0."""
    pos = jnp.asarray(pos, jnp.float32)
    n = pos.shape[0]
    wrapped, shift = wrap(pos, box)
    vel = jnp.zeros((n, 3), jnp.float32) if vel is None else jnp.asarray(vel, jnp.float32)
    return State(
        pos=wrapped,
        vel=vel,
        force=jnp.zeros((n, 3), jnp.float32),
        image=shift,
        box=box,
        potential_energy=jnp.float32(0.0),
        virial=jnp.zeros(3, jnp.float32),
        xi=jnp.float32(0.0),
    )


def thermal_velocities(key: jax.Array, mass: jax.Array, kT: float) -> jax.Array:
    """Maxwell–Boltzmann velocities with zero total momentum."""
    n = mass.shape[0]
    v = jax.random.normal(key, (n, 3), jnp.float32) * jnp.sqrt(kT / mass)[:, None]
    p = jnp.sum(v * mass[:, None], axis=0) / jnp.sum(mass)
    return v - p[None, :]


def kinetic_energy(state: State, system: System) -> jax.Array:
    return 0.5 * jnp.sum(system.mass[:, None] * state.vel**2)


def pressure(state: State, system: System) -> jax.Array:
    """Instantaneous pressure: PV = N·kT_inst + W/3 (W = Σ_d W_d)."""
    ke = kinetic_energy(state, system)
    return (2.0 * ke / 3.0 + jnp.sum(state.virial) / 3.0) / state.box.volume


def pressure_tensor(state: State, system: System) -> jax.Array:
    """Diagonal pressure tensor (3,): P_d·V = Σ_i m v_d² + W_d (the
    per-axis stress the reference's NPT uses — SURVEY.md §2b
    IntegratorTwoStep row)."""
    ke2_d = jnp.sum(system.mass[:, None] * state.vel ** 2, axis=0)
    return (ke2_d + state.virial) / state.box.volume


def temperature(state: State, system: System) -> jax.Array:
    """Instantaneous kinetic temperature; 3N − 3 DOF for momentum-conserving
    dynamics, floored at 3 so few-particle (Langevin) systems stay finite."""
    dof = max(3 * state.n - 3, 3)
    return 2.0 * kinetic_energy(state, system) / dof
