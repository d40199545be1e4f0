"""Integrator interface and the lax.scan step driver.

Reference parity: HOOMD ``IntegratorTwoStep`` + ``TwoStep*`` methods
(SURVEY.md §2b, §3.1).  An integrator is a pure function
``step(state, key) -> state`` built by a factory that closes over the force
function and parameters; strides of steps run under ``lax.scan`` so the whole
MD inner loop is one fused XLA program (SURVEY.md §7 tenet 1).
"""
from __future__ import annotations

from typing import Callable, Protocol

import jax
import jax.numpy as jnp

from ..core.state import State

StepFn = Callable[[State, jax.Array], State]


def run_steps(step: StepFn, state: State, key: jax.Array, n_steps: int) -> State:
    """Run ``n_steps`` MD steps under lax.scan with per-step key folding."""

    def body(carry, i):
        s = step(carry, jax.random.fold_in(key, i))
        return s, None

    state, _ = jax.lax.scan(body, state, jnp.arange(n_steps))
    return state
