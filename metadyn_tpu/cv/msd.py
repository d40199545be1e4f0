"""Mean-squared-displacement CV (particle-order path).

Reference parity: the MSD/displacement CV (recalled, SURVEY.md §2a):
s = (1/N)·Σ_i |r_i − r_i⁰|² against stored unwrapped reference positions;
∂s/∂r_i = 2(r_i − r_i⁰)/N comes from the shared vjp.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.state import State, System


@struct.dataclass
class MSD:
    ref_pos: jax.Array  # (N, 3) unwrapped reference positions
    name: str = struct.field(pytree_node=False, default="msd")

    @classmethod
    def create(cls, ref_pos, name: str = "msd") -> "MSD":
        return cls(ref_pos=jnp.asarray(ref_pos, jnp.float32), name=name)

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> jax.Array:
        unwrapped = state.pos + state.image.astype(state.pos.dtype) * state.box.L
        d = unwrapped - self.ref_pos
        return jnp.sum(d * d) / state.pos.shape[0]

    def bias_virial(self, state: State, system: System,
                    dVds: jax.Array) -> jax.Array:
        """Per-axis W_d = −dVds·ds/dε_d under the axis strain (r_d
        scales, the stored reference positions do not):
        ds/dε_d = (2/N)·Σ (r_d−r⁰_d)·r_d."""
        unwrapped = state.pos + state.image.astype(state.pos.dtype) * state.box.L
        d = unwrapped - self.ref_pos
        return -dVds * 2.0 * jnp.sum(d * unwrapped, axis=0) \
            / state.pos.shape[0]
