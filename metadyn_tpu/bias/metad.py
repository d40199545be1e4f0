"""Metadynamics bias engine: hill scheduling, WT scaling, FES estimators.

Reference parity: the bias-update core of ``IntegratorMetaDynamics.{h,cc}``
(recalled, SURVEY.md §3.1): every ``stride`` steps deposit a hill of height

    W' = W                      (standard)
    W' = W · exp(−V(s)/ΔT)      (well-tempered, Barducci–Bussi–Parrinello
                                 PRL 100, 020603 (2008))

onto the grid; between deposits interpolate V and ∂V/∂s at the current CV
point and feed −∂V/∂s into the bias-force chain rule.  Flux-tempered mode
lives in bias/flux.py.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from ..utils import struct

from .grid import BiasGrid, GridSpec, deposit_hill, value_and_grad

STANDARD = "standard"
WELL_TEMPERED = "well_tempered"
FLUX_TEMPERED = "flux_tempered"


@struct.dataclass
class HillSpec:
    """Mirrors ``mode_metadynamics(W=..., stride=..., deltaT=..., mode=...)``
    (recalled python API, SURVEY.md §2a)."""

    W: jax.Array                 # hill height
    stride: int = struct.field(pytree_node=False, default=500)
    mode: str = struct.field(pytree_node=False, default=STANDARD)
    deltaT: jax.Array = struct.field(default_factory=lambda: jnp.float32(1.0))

    @classmethod
    def create(cls, W: float, stride: int, mode: str = STANDARD,
               deltaT: float = 1.0) -> "HillSpec":
        assert mode in (STANDARD, WELL_TEMPERED, FLUX_TEMPERED)
        return cls(W=jnp.float32(W), stride=stride, mode=mode,
                   deltaT=jnp.float32(deltaT))


@struct.dataclass
class WallSpec:
    """Harmonic CV walls at/inside the grid edges.

    The reference integrator requires the CV to stay inside the registered
    grid (it warns/aborts otherwise — SURVEY.md §3.1); PLUMED's standard
    practice is UPPER_WALLS/LOWER_WALLS restraints.  Without a wall the
    outermost hills push the CV outward indefinitely once it leaves the
    grid (no bias can build beyond the edge), which in an ordering CV
    drives unbounded density modulation.

    u_wall(s) = k·(s − hi)² for s > hi, k·(lo − s)² for s < lo.
    """

    k: jax.Array    # (d,) spring constants
    lo: jax.Array   # (d,)
    hi: jax.Array   # (d,)

    @classmethod
    def at_grid_edges(cls, grid_spec, k: float = 1000.0,
                      margin_frac: float = 0.05) -> "WallSpec":
        span = grid_spec.hi - grid_spec.lo
        m = margin_frac * span
        return cls(k=jnp.full_like(grid_spec.lo, k),
                   lo=grid_spec.lo + m, hi=grid_spec.hi - m)

    def energy_and_grad(self, s: jax.Array) -> tuple[jax.Array, jax.Array]:
        over = jnp.maximum(s - self.hi, 0.0)
        under = jnp.maximum(self.lo - s, 0.0)
        e = jnp.sum(self.k * (over * over + under * under))
        g = 2.0 * self.k * (over - under)
        return e, g


@struct.dataclass
class BiasState:
    """Carried through the jitted loop alongside the MD state."""

    grid: BiasGrid
    n_hills: jax.Array  # () i32

    @classmethod
    def zeros(cls, spec: GridSpec) -> "BiasState":
        return cls(grid=BiasGrid.zeros(spec), n_hills=jnp.int32(0))


class HillRecord(NamedTuple):
    """One hill-file row (PLUMED-like: time/step, s⃗, σ⃗, W')."""

    step: jax.Array    # () i32
    center: jax.Array  # (d,)
    height: jax.Array  # ()


def bias_value_and_grad(bias, s: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(V(s), ∂V/∂s) for either bias representation: grid (BiasState) or
    hill list (HillListBias) — the reference's grid / non-grid duality
    (SURVEY.md §3.1)."""
    if isinstance(bias, BiasState):
        return value_and_grad(bias.grid, s)
    from .hill_list import value_and_grad as hl_vg
    return hl_vg(bias, s)


def hill_height(hills: HillSpec, bias, s: jax.Array) -> jax.Array:
    """Current deposit height W' given the existing bias at s."""
    if hills.mode == WELL_TEMPERED:
        V, _ = bias_value_and_grad(bias, s)
        return hills.W * jnp.exp(-V / hills.deltaT)
    return hills.W * jnp.ones(())


def deposit(hills: HillSpec, bias, s: jax.Array,
            step: jax.Array) -> tuple:
    h = hill_height(hills, bias, s)
    if isinstance(bias, BiasState):
        grid = deposit_hill(bias.grid, s, h)
        new = BiasState(grid=grid, n_hills=bias.n_hills + 1)
    else:
        from .hill_list import deposit as hl_deposit
        new = hl_deposit(bias, s, h)
    return new, HillRecord(step=step, center=s, height=h)


def free_energy(hills: HillSpec, bias: BiasState, kT: jax.Array) -> jax.Array:
    """FES estimate on the grid: F(s) = −V(s) (standard) or
    −(T+ΔT)/ΔT · V(s) (well-tempered), shifted so min F = 0."""
    if hills.mode == WELL_TEMPERED:
        F = -(kT + hills.deltaT) / hills.deltaT * bias.grid.V
    else:
        F = -bias.grid.V
    return F - jnp.min(F)
