"""Flux-tempered metadynamics (Singh–Chopra–de Pablo).

Reference parity: the flux-tempered mode of ``IntegratorMetaDynamics``
(recalled, SURVEY.md §3.4).  Behavioral contract: ONE collective variable;
no per-stride hill deposits — instead a visit histogram h(s) AND a
bin-crossing flux histogram f(s) accumulate every step, and at a fixed
update period the bias is rebuilt from them and the statistics reset.

Default update (``rule=FLUX``, the reference's method):

    V_new(s) = V_old(s) + (kT/2)·ln[ h(s)·f(s) / (⟨h⟩⟨f⟩) ]

which drives sampling toward the round-trip-flux-optimal distribution
p_opt ∝ 1/√D(s) (see :func:`update_bias` for the derivation).  The plain
visit-histogram half-step ΔV = kT·ln[h/⟨h⟩] remains as ``rule=VISITS``.
Derivative grids are rebuilt from V by central differences (grid-native
bias has no analytic hill derivatives).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from .grid import BiasGrid, GridSpec
from .metad import BiasState


@struct.dataclass
class FluxState:
    """Per-update-period accumulators (1-D CV)."""

    hist: jax.Array       # (n,) visit counts
    flux_up: jax.Array    # (n,) rightward bin-boundary crossings
    flux_down: jax.Array  # (n,)
    prev_bin: jax.Array   # () i32

    @classmethod
    def zeros(cls, spec: GridSpec) -> "FluxState":
        assert spec.ndim == 1, "flux-tempered metadynamics supports 1 CV"
        n = spec.shape[0]
        return cls(hist=jnp.zeros(n), flux_up=jnp.zeros(n),
                   flux_down=jnp.zeros(n), prev_bin=jnp.int32(-1))


def bin_of(spec: GridSpec, s: jax.Array) -> jax.Array:
    """Nearest grid NODE.  Bins must be centered on the nodes the update
    writes V to: floor-binning (bin b = [lo+bΔ, lo+(b+1)Δ)) samples h half
    a bin to the right of node b, and the stationary bias inherits a
    systematic F'(s)·Δ/2 offset (measured 0.13 kT on the double-well
    oracle — round-3 FT accuracy push)."""
    n = spec.shape[0]
    b = jnp.round((s[0] - spec.lo[0]) / spec.spacing(0)).astype(jnp.int32)
    if spec.periodic[0]:
        return jnp.mod(b, n)
    return jnp.clip(b, 0, n - 1)


def accumulate(flux: FluxState, spec: GridSpec, s: jax.Array) -> FluxState:
    """Per-step histogram + crossing-direction update (on device, fused)."""
    b = bin_of(spec, s)
    hist = flux.hist.at[b].add(1.0)
    up = (b > flux.prev_bin) & (flux.prev_bin >= 0)
    down = (b < flux.prev_bin) & (flux.prev_bin >= 0)
    flux_up = flux.flux_up.at[b].add(jnp.where(up, 1.0, 0.0))
    flux_down = flux.flux_down.at[b].add(jnp.where(down, 1.0, 0.0))
    return FluxState(hist=hist, flux_up=flux_up, flux_down=flux_down,
                     prev_bin=b)


VISITS = "visits"
FLUX = "flux"


def update_bias(bias: BiasState, flux: FluxState, kT: float,
                gain: float = 0.5, rule: str = FLUX
                ) -> tuple[BiasState, FluxState]:
    """Histogram → bias rebuild + statistics reset (the periodic update).

    ``rule`` selects the update:

    - ``FLUX`` (the reference's flux-tempered mode, Singh–Chopra–de Pablo;
      SURVEY.md §3.4 "(kT/2)·ln[h(s)·|flux|…]"):

          ΔV(s) = gain · (kT/2) · ln[ h(s)·f(s) / (⟨h⟩⟨f⟩) ]

      with f(s) = total bin-boundary crossings at s.  Derivation: for 1-D
      overdamped dynamics the bin-crossing rate is f/T ≈ D(s)·p(s)/Δs, so
      the local diffusivity D(s) ∝ f(s)/h(s); round-trip flux is maximized
      by p_opt(s) ∝ 1/√D(s) (Berezhkovskii–Szabo), and the bias change
      moving p → p_opt is kT·ln p + (kT/2)·ln D = (kT/2)·ln(h·f) + const.

    - ``VISITS``: the plain half-step histogram reweighting fallback
      ΔV = gain·kT·ln[h/⟨h⟩] (each update moves V halfway to −F).

    ``gain`` is the update step size; a stochastic-approximation schedule
    (e.g. 0.5/(1+k/k₀), Wang–Landau-style) damps the sampling-noise random
    walk and guarantees convergence."""
    spec = bias.grid.spec
    h = flux.hist
    # pseudocount regularization: smooth in h, and UNvisited bins receive a
    # negative increment (they become relatively attractive) instead of a
    # hard cliff at the visited/unvisited boundary — a cliff's huge FD force
    # traps the walker and the update runs away (observed)
    h_mean = jnp.mean(h)
    if rule == FLUX:
        f = flux.flux_up + flux.flux_down
        f_mean = jnp.mean(f)
        dV = gain * 0.5 * kT * (
            jnp.log((h + 1.0) / (h_mean + 1.0))
            + jnp.log((f + 1.0) / (f_mean + 1.0)))
    else:
        dV = gain * kT * jnp.log((h + 1.0) / (h_mean + 1.0))
    # 3-point binomial smoothing kills per-bin sampling noise before the
    # finite-difference derivative amplifies it
    if spec.periodic[0]:
        dV = 0.25 * jnp.roll(dV, 1) + 0.5 * dV + 0.25 * jnp.roll(dV, -1)
    else:
        pad = jnp.concatenate([dV[:1], dV, dV[-1:]])
        dV = 0.25 * pad[:-2] + 0.5 * pad[1:-1] + 0.25 * pad[2:]
    V = bias.grid.V + dV
    # derivative grid by central differences (grid-native bias)
    dx = spec.spacing(0)
    if spec.periodic[0]:
        dVds = (jnp.roll(V, -1) - jnp.roll(V, 1)) / (2 * dx)
    else:
        interior = (jnp.roll(V, -1) - jnp.roll(V, 1)) / (2 * dx)
        dVds = interior.at[0].set((V[1] - V[0]) / dx)
        dVds = dVds.at[-1].set((V[-1] - V[-2]) / dx)
    grid = BiasGrid(spec=spec, V=V, dV=dVds[None, :])
    return (BiasState(grid=grid, n_hills=bias.n_hills + 1),
            FluxState.zeros(spec))


def round_trips(flux: FluxState) -> jax.Array:
    """Convergence diagnostic: min directional flux through the mid bin."""
    mid = flux.hist.shape[0] // 2
    return jnp.minimum(flux.flux_up[mid], flux.flux_down[mid])
