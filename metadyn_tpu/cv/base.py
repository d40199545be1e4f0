"""Collective-variable framework.

Reference parity: ``metadynamics/CollectiveVariable.{h,cc}`` (recalled, see
SURVEY.md §2a) — the C++ ABC with ``getCurrentValue(timestep)`` and bias-force
application ``F_i += −bias · ∂s/∂r_i``.

Design: a CV is a pure function ``value(state, system) -> f32``;
bias forces come from ONE reverse-mode vjp through the stacked CV values with
the cotangent ``∂V/∂s`` (SURVEY.md §7 tenet 2) — the chain rule the reference
hand-codes per CV in CUDA.  Hand-fused force kernels can override this per CV
later; the vjp stays as the correctness oracle (SURVEY.md §4.1).
"""
from __future__ import annotations

from typing import Callable, Protocol, Sequence, runtime_checkable

import jax
import jax.numpy as jnp

from ..core.state import State, System


@runtime_checkable
class CollectiveVariable(Protocol):
    """Anything with a scalar ``value(state, system)`` is a CV."""

    def value(self, state: State, system: System) -> jax.Array: ...

    @property
    def log_name(self) -> str: ...


def cv_values(
    cvs: Sequence[CollectiveVariable], state: State, system: System
) -> jax.Array:
    """Stacked CV values s ∈ R^d."""
    return jnp.stack([cv.value(state, system) for cv in cvs])


def cv_values_and_bias_force(
    cvs: Sequence[CollectiveVariable],
    state: State,
    system: System,
    dV_ds: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Return (s, F_bias) where F_bias = −Σ_d (∂V/∂s_d) ∂s_d/∂r.

    One vjp covers every registered CV — the JAX analog of the reference's
    per-CV ``setBiasFactor`` + ``computeForces`` pass (SURVEY.md §3.1).
    """

    def stacked(pos: jax.Array) -> jax.Array:
        return cv_values(cvs, state.replace(pos=pos), system)

    s, vjp = jax.vjp(stacked, state.pos)
    (g,) = vjp(dV_ds)
    return s, -g
