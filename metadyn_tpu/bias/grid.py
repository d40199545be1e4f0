"""On-device bias grid: Gaussian hill deposition + interpolation of V, ∂V/∂s.

Reference parity: ``IndexGrid.{h,cc}`` + the grid mode of
``IntegratorMetaDynamics`` (recalled, SURVEY.md §2a, §3.1): V(s) accumulated
on an N-d regular grid, every-grid-point Gaussian update each deposit, and
multilinear interpolation of V and its derivative between deposits.

Design: the grid is a dense f32 array updated by one fused elementwise
kernel per deposit (no scatter — grids are small, the full-grid update is
cheap and keeps the op shape static).  Alongside V we accumulate the
*analytic* derivative grids ∂V/∂s_d (the PLUMED approach), so bias forces are
smooth multilinear interpolations instead of the noisier
derivative-of-interpolant; both derivative paths exist and are cross-tested
(SURVEY.md §7 hard part 2).
"""
from __future__ import annotations

import itertools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct


@struct.dataclass
class GridSpec:
    """Mirrors the reference CV grid registration ``(cv_min, cv_max,
    num_points, sigma)`` per CV (SURVEY.md §2a, integrate.py row)."""

    lo: jax.Array        # (d,)
    hi: jax.Array        # (d,)
    sigma: jax.Array     # (d,) hill widths
    shape: tuple = struct.field(pytree_node=False)  # (n_1, ..., n_d)
    periodic: tuple = struct.field(pytree_node=False)  # (bool, ...) per dim

    @classmethod
    def create(cls, lo: Sequence[float], hi: Sequence[float],
               num_points: Sequence[int], sigma: Sequence[float],
               periodic: Sequence[bool] | None = None) -> "GridSpec":
        lo = np.atleast_1d(np.asarray(lo, np.float32))
        hi = np.atleast_1d(np.asarray(hi, np.float32))
        num_points = tuple(int(n) for n in np.atleast_1d(num_points))
        sigma = np.atleast_1d(np.asarray(sigma, np.float32))
        periodic = tuple(bool(p) for p in (periodic or [False] * len(num_points)))
        assert len(lo) == len(hi) == len(num_points) == len(sigma) == len(periodic)
        return cls(lo=jnp.asarray(lo), hi=jnp.asarray(hi), sigma=jnp.asarray(sigma),
                   shape=num_points, periodic=periodic)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def axis_coords(self, d: int) -> jax.Array:
        """Grid-point coordinates along dimension d (n_d,)."""
        n = self.shape[d]
        if self.periodic[d]:
            # periodic: hi is the period end, no duplicated endpoint
            return self.lo[d] + (self.hi[d] - self.lo[d]) * jnp.arange(n) / n
        return self.lo[d] + (self.hi[d] - self.lo[d]) * jnp.arange(n) / (n - 1)

    def spacing(self, d: int) -> jax.Array:
        n = self.shape[d]
        denom = n if self.periodic[d] else (n - 1)
        return (self.hi[d] - self.lo[d]) / denom


@struct.dataclass
class BiasGrid:
    """V(s) plus analytic derivative grids, all dense f32 on device."""

    spec: GridSpec
    V: jax.Array    # (*shape,)
    dV: jax.Array   # (d, *shape) — ∂V/∂s_d at each grid point

    @classmethod
    def zeros(cls, spec: GridSpec) -> "BiasGrid":
        return cls(
            spec=spec,
            V=jnp.zeros(spec.shape, jnp.float32),
            dV=jnp.zeros((spec.ndim, *spec.shape), jnp.float32),
        )


def _hill_factors(spec: GridSpec, s: jax.Array):
    """Per-dimension Gaussian factors and their s-derivative prefactors.

    Returns lists of (n_d,) arrays: g_d = exp(−Δ²/2σ²) and
    h_d = −Δ/σ² (so ∂/∂x_d of the hill is h_d · hill).
    Periodic dims sum over the nearest image only (σ ≪ period assumed,
    matching the reference's wrapped-grid behavior).
    """
    gs, hs = [], []
    for d in range(spec.ndim):
        x = spec.axis_coords(d)
        delta = x - s[d]
        if spec.periodic[d]:
            period = spec.hi[d] - spec.lo[d]
            delta = delta - period * jnp.round(delta / period)
        sig = spec.sigma[d]
        gs.append(jnp.exp(-0.5 * (delta / sig) ** 2))
        hs.append(-delta / (sig * sig))
    return gs, hs


def hill_field(spec: GridSpec, s: jax.Array, height: jax.Array
               ) -> tuple[jax.Array, jax.Array]:
    """Full-grid (ΔV, ΔdV) contribution of one Gaussian hill at s.

    Split out of :func:`deposit_hill` so multi-walker metadynamics can psum
    the per-walker fields over the walker mesh axis before applying them
    (the reference's MPI_Allreduce of the grid delta, SURVEY.md §3.1)."""
    gs, hs = _hill_factors(spec, s)
    # outer product of per-dim factors via broadcasting
    hill = height
    for d, g in enumerate(gs):
        sh = [1] * spec.ndim
        sh[d] = -1
        hill = hill * g.reshape(sh)
    dV = []
    for d in range(spec.ndim):
        sh = [1] * spec.ndim
        sh[d] = -1
        dV.append(hill * hs[d].reshape(sh))
    return hill, jnp.stack(dV)


def deposit_hill(grid: BiasGrid, s: jax.Array, height: jax.Array) -> BiasGrid:
    """Add one Gaussian hill of the given height centred at s to the grid.

    The full-grid update the reference does per stride (SURVEY.md §3.1
    ``V[g] += W'·exp(...)``), fused into one elementwise op.
    """
    dV_hill, ddV = hill_field(grid.spec, s, height)
    return grid.replace(V=grid.V + dV_hill, dV=grid.dV + ddV)


def _interp_weights(spec: GridSpec, s: jax.Array):
    """Lower corner indices (d,) i32 and fractional offsets (d,) f32.

    Out-of-range s is clamped to the grid (reference behavior: CV expected
    within grid bounds; clamping keeps the step NaN-free, and the overflow
    is surfaced in sampler metrics)."""
    idx, frac = [], []
    for d in range(spec.ndim):
        n = spec.shape[d]
        dx = spec.spacing(d)
        t = (s[d] - spec.lo[d]) / dx
        if spec.periodic[d]:
            t = jnp.mod(t, n)
            i0 = jnp.floor(t).astype(jnp.int32)
            f = t - i0
            i0 = jnp.clip(i0, 0, n - 1)
        else:
            # clamp the INDEX (not t by an epsilon that vanishes in f32):
            # i0 ∈ [0, n−2] so the upper corner i0+1 is always a real point
            t = jnp.clip(t, 0.0, jnp.float32(n - 1))
            i0 = jnp.minimum(jnp.floor(t).astype(jnp.int32),
                             jnp.int32(max(n - 2, 0)))
            f = t - i0
        idx.append(i0)
        frac.append(f)
    return idx, frac


def _gather_corner(arr: jax.Array, spec: GridSpec, idx, corner):
    ix = []
    for d in range(spec.ndim):
        i = idx[d] + corner[d]
        n = spec.shape[d]
        i = jnp.mod(i, n) if spec.periodic[d] else jnp.minimum(i, n - 1)
        ix.append(i)
    return arr[tuple(ix)]


def interp(arr: jax.Array, spec: GridSpec, s: jax.Array) -> jax.Array:
    """Multilinear interpolation of a (*shape,) grid array at point s (d,)."""
    idx, frac = _interp_weights(spec, s)
    out = 0.0
    for corner in itertools.product((0, 1), repeat=spec.ndim):
        w = 1.0
        for d, c in enumerate(corner):
            w = w * (frac[d] if c else (1.0 - frac[d]))
        out = out + w * _gather_corner(arr, spec, idx, corner)
    return out


def value_and_grad(grid: BiasGrid, s: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(V(s), ∂V/∂s) — V from the value grid, gradient from the analytic
    derivative grids, both multilinearly interpolated (SURVEY.md §3.1)."""
    V = interp(grid.V, grid.spec, s)
    dV = jnp.stack([interp(grid.dV[d], grid.spec, s) for d in range(grid.spec.ndim)])
    return V, dV


def grad_fd(grid: BiasGrid, s: jax.Array) -> jax.Array:
    """Cross-check gradient: derivative of the multilinear interpolant of V
    (central difference over one grid spacing) — the reference's
    finite-difference-on-grid option (SURVEY.md §7 hard part 2)."""
    out = []
    for d in range(grid.spec.ndim):
        dx = grid.spec.spacing(d)
        e = jnp.zeros(grid.spec.ndim).at[d].set(0.5 * dx)
        out.append((interp(grid.V, grid.spec, s + e) - interp(grid.V, grid.spec, s - e)) / dx)
    return jnp.stack(out)
