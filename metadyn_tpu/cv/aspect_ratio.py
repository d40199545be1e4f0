"""Box aspect-ratio CV — box-shape metadynamics under NPT.

Reference parity: ``metadynamics/AspectRatio.{h,cc}`` (recalled, SURVEY.md
§2a): s = L_a/L_b; the bias couples to the BOX degrees of freedom, not to
particle forces.  With the SCR barostat (integrate/npt.py) the bias enters
through ``box_bias_fn``; :func:`box_bias_fn_for` builds it from the
sampler's bias grid.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.state import State, System
from ..bias.grid import BiasGrid, value_and_grad


@struct.dataclass
class AspectRatio:
    """s = L[axis_a] / L[axis_b]."""

    axis_a: int = struct.field(pytree_node=False, default=0)
    axis_b: int = struct.field(pytree_node=False, default=1)
    name: str = struct.field(pytree_node=False, default="aspect")

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> jax.Array:
        return state.box.L[self.axis_a] / state.box.L[self.axis_b]

    def dvalue_dL(self, state: State) -> jax.Array:
        """(3,) ∂s/∂L."""
        La = state.box.L[self.axis_a]
        Lb = state.box.L[self.axis_b]
        g = jnp.zeros(3)
        g = g.at[self.axis_a].set(1.0 / Lb)
        g = g.at[self.axis_b].set(-La / (Lb * Lb))
        return g


def box_bias_fn_for(cv: AspectRatio, bias):
    """Build ``box_bias_fn(state) -> ∂V_bias/∂L`` for the NPT integrator.

    ``bias`` is the live BiasState of the stride chunk: pass a two-argument
    ``integrator_factory(force_fn, bias)`` to MetadSampler and construct
    the NPT step with ``box_bias_fn=box_bias_fn_for(cv, bias)`` — the bias
    grid is then interpolated at the CURRENT box shape on every step
    inside the jitted chunk (box-shape metadynamics end-to-end)."""

    def fn(state: State) -> jax.Array:
        s = jnp.stack([state.box.L[cv.axis_a] / state.box.L[cv.axis_b]])
        _, dVds = value_and_grad(bias.grid, s)
        return dVds[0] * cv.dvalue_dL(state)

    return fn
