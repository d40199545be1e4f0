"""Hill-list (non-grid) bias mode.

Reference parity: ``IntegratorMetaDynamics`` with NO grid registered keeps
V(s) as an in-memory list of deposited hills and evaluates V and ∂V/∂s by
an analytic sum over all hills each step (recalled, SURVEY.md §3.1
"non-grid mode: append hill (s⃗, W') to in-memory list"; §7 hard part 3).

Design: a FIXED-capacity on-device hill buffer (centers,
heights) carried through the jitted stride scan; the O(n_hills) analytic
sum is a masked dense reduction over the buffer (shape-static, fuses into
the step).  When the buffer fills, new hills either **spill onto a coarse
grid** (configure ``spill_spec``) so no bias is ever lost, or are dropped
with a surfaced ``overflowed`` flag — the capped-list + spill-to-grid
policy of SURVEY.md §7 hard part 3.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from .grid import BiasGrid, GridSpec, hill_field, interp


@struct.dataclass
class HillListBias:
    """Capped hill buffer (+ optional spill grid), carried on device."""

    centers: jax.Array            # (capacity, d)
    heights: jax.Array            # (capacity,)
    sigma: jax.Array              # (d,) shared hill widths
    n_hills: jax.Array            # () i32 — total deposited (incl. spilled)
    overflowed: jax.Array         # () bool — any hill dropped (no spill)
    spill: Optional[BiasGrid]     # coarse grid for overflow hills, or None

    @property
    def capacity(self) -> int:
        return self.centers.shape[0]

    @classmethod
    def create(cls, sigma: Sequence[float], capacity: int = 4096,
               spill_spec: Optional[GridSpec] = None) -> "HillListBias":
        sig = jnp.atleast_1d(jnp.asarray(sigma, jnp.float32))
        d = sig.shape[0]
        return cls(
            centers=jnp.zeros((capacity, d), jnp.float32),
            heights=jnp.zeros((capacity,), jnp.float32),
            sigma=sig,
            n_hills=jnp.int32(0),
            overflowed=jnp.asarray(False),
            spill=BiasGrid.zeros(spill_spec) if spill_spec is not None else None,
        )


def value_and_grad(bias: HillListBias, s: jax.Array
                   ) -> tuple[jax.Array, jax.Array]:
    """Analytic V(s), ∂V/∂s over the hill buffer (+ spill grid interp).

    The reference's O(n_hills) per-step hot spot (SURVEY.md §3.1) as one
    masked dense reduction."""
    d = (s[None, :] - bias.centers) / bias.sigma[None, :]     # (cap, dim)
    g = jnp.exp(-0.5 * jnp.sum(d * d, axis=1))                # (cap,)
    k = jnp.arange(bias.capacity)
    w = jnp.where(k < jnp.minimum(bias.n_hills, bias.capacity),
                  bias.heights * g, 0.0)
    V = jnp.sum(w)
    grad = jnp.sum(w[:, None] * (-d / bias.sigma[None, :]), axis=0)
    if bias.spill is not None:
        from .grid import value_and_grad as grid_vg
        Vs, gs = grid_vg(bias.spill, s)
        V = V + Vs
        grad = grad + gs
    return V, grad


def deposit(bias: HillListBias, s: jax.Array, height: jax.Array
            ) -> HillListBias:
    """Append one hill; past capacity, spill to the coarse grid (or drop
    with the overflow flag raised).  Shape-static and jit-safe."""
    idx = jnp.minimum(bias.n_hills, bias.capacity - 1)
    in_buf = bias.n_hills < bias.capacity
    centers = bias.centers.at[idx].set(
        jnp.where(in_buf, s, bias.centers[idx]))
    heights = bias.heights.at[idx].set(
        jnp.where(in_buf, height, bias.heights[idx]))
    spill = bias.spill
    overflowed = bias.overflowed
    if spill is not None:
        dV, ddV = hill_field(spill.spec, s, jnp.where(in_buf, 0.0, height))
        spill = spill.replace(V=spill.V + dV, dV=spill.dV + ddV)
    else:
        overflowed = overflowed | ~in_buf
    return bias.replace(centers=centers, heights=heights, spill=spill,
                        n_hills=bias.n_hills + 1, overflowed=overflowed)


def evaluate_on_grid(bias: HillListBias, spec: GridSpec) -> jax.Array:
    """Dense V(s) on a query grid (FES reconstruction / parity checks)."""
    axes = [spec.axis_coords(d) for d in range(spec.ndim)]
    mesh = jnp.meshgrid(*axes, indexing="ij")
    pts = jnp.stack([m.reshape(-1) for m in mesh], axis=1)     # (P, dim)
    V = jax.vmap(lambda p: value_and_grad(bias, p)[0])(pts)
    return V.reshape(spec.shape)
