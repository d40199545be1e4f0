"""Steinhardt Q_l bond-order parameter CV.

Reference parity: ``metadynamics/SteinhardtQl.{h,cc,cu}`` (recalled,
SURVEY.md §2a):

    Q_l = sqrt( 4π/(2l+1) · Σ_{m=−l..l} | ⟨Y_lm(r̂_ij)⟩_bonds |² )

averaged over all neighbor bonds within r_cut.  The CUDA dY_lm chain-rule
kernel becomes the shared vjp (SURVEY.md §7 hard part 4: grad first, fuse
later).

Spherical harmonics are evaluated singularity-free in Cartesian form:
Y_lm = N_lm · p_lm(cosθ) · (sinθ e^{iφ})^m, where p_lm = P_l^m / sin^mθ is
a polynomial in cosθ and (sinθ e^{iφ})^m = ((x+iy)/r)^m — smooth at the
poles.  p_lm coefficients are generated numerically for any l.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.box import minimum_image
from ..core.state import State, System


@lru_cache(maxsize=None)
def _plm_over_sinm_coeffs(l: int) -> tuple:
    """Coefficients (in cosθ) of P_l^m(cosθ)/sin^mθ for m=0..l.

    Built from the recurrence on associated Legendre polynomials expressed
    as polynomials: P_l^m(x) = (-1)^m (1-x²)^{m/2} d^m/dx^m P_l(x), so
    P_l^m/sin^m = (-1)^m · d^m/dx^m P_l(x).  Returns a tuple of numpy
    coefficient arrays (ascending powers).
    """
    # Legendre polynomial P_l coefficients (ascending powers of x)
    p = np.zeros(l + 1)
    for k in range(l // 2 + 1):
        c = ((-1) ** k * math.factorial(2 * l - 2 * k)
             / (2 ** l * math.factorial(k) * math.factorial(l - k)
                * math.factorial(l - 2 * k)))
        p[l - 2 * k] = c
    out = []
    d = p.copy()
    for m in range(l + 1):
        out.append(((-1) ** m) * d.copy())
        # differentiate
        d = np.asarray([d[i] * i for i in range(1, d.shape[0])] or [0.0])
    return tuple(out)


def _norms(l: int) -> np.ndarray:
    return np.asarray([
        math.sqrt((2 * l + 1) / (4 * math.pi)
                  * math.factorial(l - m) / math.factorial(l + m))
        for m in range(l + 1)
    ], np.float32)


def ylm_bond_sums(dx, dy, dz, weight, l: int):
    """Σ_bonds w·Y_lm for m=0..l as (real, imag) arrays of shape (l+1,).

    dx/dy/dz: (B,) bond vectors, weight: (B,) mask/weights.
    """
    r2 = dx * dx + dy * dy + dz * dz
    # guard BEFORE the sqrt — d√(0) is inf and poisons autodiff even under
    # a zero weight (the usual where-trap)
    r = jnp.sqrt(jnp.where(r2 > 1e-12, r2, 1.0))
    c = dz / r                                     # cosθ
    # (sinθ e^{iφ})^m = ((x+iy)/r)^m, computed by real recurrence
    ux, uy = dx / r, dy / r
    coeffs = _plm_over_sinm_coeffs(l)
    norms = _norms(l)
    re, im = [], []
    pr, pi = jnp.ones_like(c), jnp.zeros_like(c)   # u^0
    for m in range(l + 1):
        poly = coeffs[m]
        pl = jnp.zeros_like(c)
        for a in poly[::-1]:
            pl = pl * c + a
        re.append(jnp.sum(weight * norms[m] * pl * pr))
        im.append(jnp.sum(weight * norms[m] * pl * pi))
        pr, pi = pr * ux - pi * uy, pr * uy + pi * ux  # u^{m+1}
    return jnp.stack(re), jnp.stack(im)


def ql_from_sums(re, im, n_bonds, l: int):
    """Q_l from Σ Y_lm and the bond count (uses |Y_{l,-m}| = |Y_lm|)."""
    q2 = (re[0] ** 2 + im[0] ** 2) + 2.0 * jnp.sum(re[1:] ** 2 + im[1:] ** 2)
    nb = jnp.maximum(n_bonds, 1.0)
    return jnp.sqrt(4.0 * jnp.pi / (2 * l + 1) * q2) / nb


@struct.dataclass
class SteinhardtQl:
    """Global Q_l over all pair bonds within r_cut (all-pairs evaluation —
    fine for the small/medium particle-order path; the packed twin lives in
    cv/packed.py)."""

    r_cut: float = struct.field(pytree_node=False, default=1.5)
    l: int = struct.field(pytree_node=False, default=6)
    row_block: int = struct.field(pytree_node=False, default=512)
    name: str = struct.field(pytree_node=False, default="q6")

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> jax.Array:
        pos = state.pos
        n = pos.shape[0]
        # all-pairs bond sweep in row blocks (both bond directions counted,
        # matching the full neighbor-list convention)
        re_t = jnp.zeros(self.l + 1)
        im_t = jnp.zeros(self.l + 1)
        nb = jnp.float32(0.0)
        rb = min(self.row_block, n)
        n_blocks = -(-n // rb)
        pos_p = jnp.concatenate(
            [pos, jnp.zeros((n_blocks * rb - n, 3), pos.dtype)])
        ids = jnp.arange(n_blocks * rb, dtype=jnp.int32)

        def block(carry, b):
            re_t, im_t, nb = carry
            sl = b * rb
            rp = jax.lax.dynamic_slice_in_dim(pos_p, sl, rb)
            rid = jax.lax.dynamic_slice_in_dim(ids, sl, rb)
            dr = minimum_image(rp[:, None, :] - pos[None, :, :], state.box)
            r2 = jnp.sum(dr * dr, axis=-1)
            ok = ((r2 < self.r_cut ** 2)
                  & (rid[:, None] != jnp.arange(n)[None, :])
                  & (rid[:, None] < n))
            w = ok.astype(jnp.float32).reshape(-1)
            re, im = ylm_bond_sums(
                dr[..., 0].reshape(-1), dr[..., 1].reshape(-1),
                dr[..., 2].reshape(-1), w, self.l)
            return (re_t + re, im_t + im, nb + jnp.sum(w)), None

        (re_t, im_t, nb), _ = jax.lax.scan(
            block, (re_t, im_t, nb), jnp.arange(n_blocks))
        return ql_from_sums(re_t, im_t, nb, self.l)
