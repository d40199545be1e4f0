"""Order-parameter CVs on the packed state: Steinhardt Q_l and coordination.

Reference parity: ``SteinhardtQl`` (SURVEY.md §2a) evaluated on the packed
hot path, plus a smooth coordination-number CV (the "density" axis of the
Config-3 nucleation pair, BASELINE.json:9 — standard practice for
crystal-nucleation metadynamics).

Both reuse the gather-free 27-offset roll sweep of the pair force (see
ops/packed.py): neighbor bonds are enumerated as (cap_j, cap_i, C)
broadcasts per offset with zero dynamic indexing; forces come from the
shared CV vjp.  Requires r_cut ≤ spec.r_list (stencil coverage).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.state import System
from ..ops.packed import (PackedSpec, PackedState, _roll_offsets,
                          shift_rows_cart)
from .steinhardt import _plm_over_sinm_coeffs, _norms, ql_from_sums


def _half_partner_stacks(state: PackedState, spec: PackedSpec):
    """Rolled+shifted partner stacks for the Newton-halved offset set:
    list of (o, xj3, vj) with xj3 three (cap, C) coordinate arrays and vj
    the partner validity (cap, C).  Built ONCE per step and shared by the
    value and force sweeps (VERDICT r2 weak #2: the stacks were rebuilt
    up to 4× per step before)."""
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    view = lambda a: a.reshape(cap, cx, cy, cz)
    x4 = [view(state.r[d].reshape(cap, C)) for d in range(3)]
    valid4 = view((state.pid < spec.n_real).astype(jnp.float32).reshape(cap, C))
    out = []
    for (o, ushift) in _roll_offsets(spec):
        if o < (0, 0, 0):
            continue
        roll = lambda a: jnp.roll(a, shift=(-o[0], -o[1], -o[2]),
                                  axis=(1, 2, 3))
        shift = shift_rows_cart(ushift, state.box)
        xj3 = [roll(x4[d]).reshape(cap, C) + shift[d][None, :]
               for d in range(3)]
        vj = roll(valid4).reshape(cap, C)
        out.append((o, xj3, vj))
    return out


def _offset_pair_sweep(state: PackedState, spec: PackedSpec, per_pair,
                       half: bool = False, stacks=None):
    """Accumulate Σ_pairs per_pair(dx, dy, dz, r2, w_pair) over the roll
    structure.  ``per_pair`` returns a pytree of scalars; w_pair is the
    validity weight (1 for real–real pairs inside r_list).

    ``half=True`` (Newton halving): only the self offset + the 13
    lexicographically-positive offsets are enumerated, with cross-cell
    pair weight 2 — VALID ONLY for per_pair functions even under
    d → −d (Q_l with even l: Y_lm parity (−1)^l; coordination: r²-only).
    ``stacks``: prebuilt :func:`_half_partner_stacks` (half mode only)."""
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    view = lambda a: a.reshape(cap, cx, cy, cz)
    valid = (state.pid < spec.n_real).astype(jnp.float32).reshape(cap, C)
    vi = valid[None, :, :]
    xi = [state.r[d].reshape(cap, C)[None, :, :] for d in range(3)]
    acc = None
    if half and stacks is None:
        stacks = _half_partner_stacks(state, spec)
    if half:
        it = ((o, xj3, vj) for (o, xj3, vj) in stacks)
    else:
        x4 = [view(state.r[d].reshape(cap, C)) for d in range(3)]
        valid4 = view(valid)

        def full_iter():
            for (o, ushift) in _roll_offsets(spec):
                roll = lambda a: jnp.roll(a, shift=(-o[0], -o[1], -o[2]),
                                          axis=(1, 2, 3))
                shift = shift_rows_cart(ushift, state.box)
                xj3 = [roll(x4[d]).reshape(cap, C)
                       + shift[d][None, :] for d in range(3)]
                yield o, xj3, roll(valid4).reshape(cap, C)
        it = full_iter()
    for (o, xj3, vj) in it:
        wt = 2.0 if (half and o != (0, 0, 0)) else 1.0
        dxs = []
        r2 = jnp.zeros((cap, cap, C), jnp.float32)
        for d in range(3):
            c = xi[d] - xj3[d][:, None, :]
            dxs.append(c)
            r2 = r2 + c * c
        w = wt * vi * vj[:, None, :] * (r2 > 1e-12)
        out = per_pair(dxs[0], dxs[1], dxs[2], r2, w)
        acc = out if acc is None else jax.tree.map(jnp.add, acc, out)
    return acc


def _offset_force_sweep(state: PackedState, spec: PackedSpec, pair_grad,
                        stacks=None):
    """Accumulate F_i = Σ_j w·pair_grad(d_ij) over the Newton-halved
    offset set — returns (3, Npad).  ``pair_grad(dx,dy,dz,r2)`` must be
    the d-gradient of an EVEN per-pair scalar φ; per ordered pair the i
    side gets +φ'(d) and the j side −φ'(d) = +φ'(d_ji) (parity), so the
    half sweep with a rolled-back reaction reproduces the full one.
    ``stacks``: prebuilt :func:`_half_partner_stacks` to share with the
    value sweep."""
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    view = lambda a: a.reshape(cap, cx, cy, cz)
    roll_back = lambda a, o: jnp.roll(view(a), shift=(o[0], o[1], o[2]),
                                      axis=(1, 2, 3)).reshape(cap, C)
    valid = (state.pid < spec.n_real).astype(jnp.float32).reshape(cap, C)
    vi = valid[None, :, :]
    xi = [state.r[d].reshape(cap, C)[None, :, :] for d in range(3)]
    if stacks is None:
        stacks = _half_partner_stacks(state, spec)
    fx = [jnp.zeros((cap, C), jnp.float32) for _ in range(3)]
    for (o, xj3, vj) in stacks:
        dxs = []
        r2 = jnp.zeros((cap, cap, C), jnp.float32)
        for d in range(3):
            c = xi[d] - xj3[d][:, None, :]
            dxs.append(c)
            r2 = r2 + c * c
        w = vi * vj[:, None, :] * (r2 > 1e-12)
        gx, gy, gz = pair_grad(dxs[0], dxs[1], dxs[2], r2)
        for d, g in enumerate((gx, gy, gz)):
            wg = w * g
            fx[d] = fx[d] + jnp.sum(wg, axis=0)       # i side
            if o != (0, 0, 0):
                # j-side reaction in the rolled frame, rolled back
                fx[d] = fx[d] - roll_back(jnp.sum(wg, axis=1), o)
    return jnp.stack([f.reshape(-1) for f in fx])


@struct.dataclass
class PackedSteinhardtQl:
    """Global Q_l over all pair bonds within r_cut (packed twin of
    cv.steinhardt.SteinhardtQl; bonds counted from both sides)."""

    spec: PackedSpec
    r_cut: float = struct.field(pytree_node=False, default=1.5)
    l: int = struct.field(pytree_node=False, default=6)
    name: str = struct.field(pytree_node=False, default="q6")

    def __post_init__(self):
        assert self.r_cut <= self.spec.r_list + 1e-6, (
            "Q_l r_cut must be within the cell stencil (r_cut + skin)")
        assert self.l % 2 == 0, (
            "packed Q_l uses the Newton-halved sweep (parity (−1)^l): "
            "even l only (the global sum vanishes for odd l anyway)")

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def pair_value_terms(self, dx, dy, dz, r2, w):
        """Per-pair partials for the fused roll sweep: (Re S_m, Im S_m, n_b)."""
        coeffs = _plm_over_sinm_coeffs(self.l)
        norms = _norms(self.l)
        rcq2 = self.r_cut ** 2
        w = w * (r2 < rcq2)
        r2s = jnp.where(r2 > 1e-12, r2, 1.0)
        inv_r = jax.lax.rsqrt(r2s)
        cth = dz * inv_r
        ux, uy = dx * inv_r, dy * inv_r
        pr = jnp.ones_like(cth)
        pi = jnp.zeros_like(cth)
        re, im = [], []
        for m in range(self.l + 1):
            pl_ = jnp.zeros_like(cth)
            for a in coeffs[m][::-1]:
                pl_ = pl_ * cth + a
            re.append(jnp.sum(w * norms[m] * pl_ * pr))
            im.append(jnp.sum(w * norms[m] * pl_ * pi))
            pr, pi = pr * ux - pi * uy, pr * uy + pi * ux
        return (jnp.stack(re), jnp.stack(im), jnp.sum(w))

    def finalize_value(self, terms) -> jax.Array:
        re, im, nb = terms
        return ql_from_sums(re, im, nb, self.l)

    def _sums(self, state: PackedState, stacks=None):
        return _offset_pair_sweep(state, self.spec, self.pair_value_terms,
                                  half=True, stacks=stacks)

    def value(self, state: PackedState, system: System) -> jax.Array:
        return self.finalize_value(self._sums(state))

    def grad_aux(self, terms, dVds):
        """Outer gradient (g_m = ∂Q/∂S_m over 2l+3 scalars), with the
        bias-force coefficient −2·dVds folded in (both pair orderings hit
        the i side — even parity)."""
        re, im, nb = terms
        gre, gim = jax.grad(
            lambda a, b: ql_from_sums(a, b, nb, self.l), argnums=(0, 1)
        )(re, im)
        return -2.0 * dVds * gre, -2.0 * dVds * gim

    def pair_grad_terms(self, dx, dy, dz, r2, aux):
        """Closed-form per-pair bias-force contribution (coefficient and
        sign already folded into ``aux`` by :meth:`grad_aux`).

        Per ordered pair the scalar φ(d) = Σ_m N_m p_m(cosθ)·
        Re[(g^re_m − i g^im_m)·u^m] is differentiated in closed form
        (u = (dx+i dy)/r); both orderings contribute +∂φ/∂d to particle
        i (even parity), so the sweep needs no j-side scatter.  The
        hard-cutoff weight has zero gradient a.e. (∂nb/∂r ≡ 0)."""
        gre, gim = aux
        coeffs = _plm_over_sinm_coeffs(self.l)
        dcoeffs = [np.asarray([c[i] * i for i in range(1, c.shape[0])]
                              or [0.0]) for c in coeffs]
        norms = _norms(self.l)
        rcq2 = self.r_cut ** 2
        inside = (r2 < rcq2)
        r2s = jnp.where(r2 > 1e-12, r2, 1.0)
        inv_r = jax.lax.rsqrt(r2s)
        cth = dz * inv_r
        ux, uy = dx * inv_r, dy * inv_r
        pr = jnp.ones_like(cth)      # Re u^m
        pi = jnp.zeros_like(cth)     # Im u^m
        qr = jnp.zeros_like(cth)     # Re u^{m-1}
        qi = jnp.zeros_like(cth)
        D = jnp.zeros_like(cth)      # Σ N_m p'_m(c)·Re[A_m u^m]
        E = jnp.zeros_like(cth)      # Σ N_m p_m(c)·Br_m
        F = jnp.zeros_like(cth)      # Σ N_m p_m(c)·Bi_m
        BU = jnp.zeros_like(cth)     # Σ N_m p_m(c)·Re[B_m·u]
        for m in range(self.l + 1):
            pl_ = jnp.zeros_like(cth)
            for a in coeffs[m][::-1]:
                pl_ = pl_ * cth + a
            dpl = jnp.zeros_like(cth)
            for a in dcoeffs[m][::-1]:
                dpl = dpl * cth + a
            a_re = gre[m]
            a_im = gim[m]
            D = D + norms[m] * dpl * (a_re * pr + a_im * pi)
            if m > 0:
                br = m * (a_re * qr + a_im * qi)
                bi = m * (a_re * qi - a_im * qr)
                E = E + norms[m] * pl_ * br
                F = F + norms[m] * pl_ * bi
                BU = BU + norms[m] * pl_ * (br * ux - bi * uy)
            qr, qi = pr, pi
            pr, pi = pr * ux - pi * uy, pr * uy + pi * ux
        gx = (D * (-cth * ux) + E - ux * BU) * inv_r
        gy = (D * (-cth * uy) - F - uy * BU) * inv_r
        gz = (D * (1.0 - cth * cth) - cth * BU) * inv_r
        z = jnp.float32(0.0)
        return (jnp.where(inside, gx, z), jnp.where(inside, gy, z),
                jnp.where(inside, gz, z))

    def accum_bias_force(self, state: PackedState, system: System,
                         dVds: jax.Array, f_acc: jax.Array) -> jax.Array:
        """Hot-path analytic bias force (SURVEY.md §7 hard part 4, the
        "fuse later" step; oracle-tested against the vjp path).

        Two passes: (1) the value sums (S_m, nb); (2) the tiny outer
        gradient g_m = ∂Q/∂S_m (jax.grad over 2l+3 scalars) contracted
        into ONE analytic pair sweep.  (The fused multi-CV path in
        sampler.make_biased_force shares the sweeps ACROSS CVs instead
        of calling this — same math, one traversal.)"""
        aux = self.grad_aux(self._sums(state), dVds)
        g = _offset_force_sweep(
            state, self.spec,
            lambda dx, dy, dz, r2: self.pair_grad_terms(dx, dy, dz, r2, aux))
        return f_acc + g


@struct.dataclass
class PackedCoordination:
    """Smooth mean coordination number (PLUMED COORDINATION switching):

        s = (1/N) Σ_pairs [1 − (r/r0)^6] / [1 − (r/r0)^12]

    — the standard "density/structure" companion CV for nucleation.

    ``r_cut=None`` (default) truncates at the cell stencil reach (legacy
    behavior; value depends weakly on the cell decomposition).  A finite
    ``r_cut`` applies the PLUMED-style STRETCH: s̃ = (s − s(r_cut)) /
    (1 − s(r_cut)) for r < r_cut, 0 beyond — continuous at the cutoff
    and decomposition-independent.  Required for the neighbor-table hot
    path (the table radius must bound every CV cutoff).
    """

    spec: PackedSpec
    r0: float = struct.field(pytree_node=False, default=1.5)
    name: str = struct.field(pytree_node=False, default="coord")
    r_cut: float | None = struct.field(pytree_node=False, default=None)

    def __post_init__(self):
        # the switching tail is negligible past ~1.5·r0; require coverage
        assert self.r0 * 1.5 <= self.spec.r_list + 1e-6, (
            "coordination r0 too large for the cell stencil")

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _stretch(self):
        """(s_c, scale): switching value at the cutoff and the stretch
        factor 1/(1 − s_c) — static Python floats."""
        sc = 1.0 / (1.0 + (self.r_cut / self.r0) ** 6)
        return sc, 1.0 / (1.0 - sc)

    def pair_value_terms(self, dx, dy, dz, r2, w):
        # [1−(r/r0)^6]/[1−(r/r0)^12] ≡ 1/(1+(r/r0)^6): regular form —
        # the quotient form NaN-poisons autodiff near r = r0
        r02 = self.r0 ** 2
        y3 = (r2 / r02) ** 3          # (r/r0)^6
        s = 1.0 / (1.0 + y3)
        if self.r_cut is not None:
            sc, scale = self._stretch()
            s = jnp.where(r2 < self.r_cut ** 2, (s - sc) * scale, 0.0)
        return (jnp.sum(w * s),)

    def finalize_value(self, terms) -> jax.Array:
        return terms[0] / self.spec.n_real

    def value(self, state: PackedState, system: System) -> jax.Array:
        return self.finalize_value(_offset_pair_sweep(
            state, self.spec, self.pair_value_terms, half=True))

    def grad_aux(self, terms, dVds):
        """Bias-force coefficient: −dVds·2/N for the two pair orderings
        (even parity), folded into the per-pair coefficient."""
        return -dVds * 2.0 / self.spec.n_real

    def pair_grad_terms(self, dx, dy, dz, r2, aux):
        """φ(d) = 1/(1+(r²/r0²)³), ∂φ/∂d = −3t²/(r0²(1+t³)²)·2d with
        t = r²/r0²; ``aux`` carries the folded bias coefficient.  With
        ``r_cut`` the stretch multiplies the derivative by 1/(1−s_c) and
        zeroes it past the cutoff (the stretch offset is constant)."""
        r02 = self.r0 ** 2
        t = r2 / r02
        t3 = t * t * t
        dphi_dr2 = -3.0 * t * t / (r02 * (1.0 + t3) ** 2)
        if self.r_cut is not None:
            _, scale = self._stretch()
            dphi_dr2 = jnp.where(r2 < self.r_cut ** 2,
                                 dphi_dr2 * scale, 0.0)
        c = aux * 2.0 * dphi_dr2
        return c * dx, c * dy, c * dz

    def accum_bias_force(self, state: PackedState, system: System,
                         dVds: jax.Array, f_acc: jax.Array) -> jax.Array:
        aux = self.grad_aux(None, dVds)
        g = _offset_force_sweep(
            state, self.spec,
            lambda dx, dy, dz, r2: self.pair_grad_terms(dx, dy, dz, r2, aux))
        return f_acc + g


def make_fused_order_force(cvs, spec: PackedSpec):
    """Fused multi-CV roll sweep: ONE value traversal + ONE force
    traversal for ALL order CVs, sharing the rolled partner stacks
    (VERDICT r2 weak #2: Config-3 ran 4–5 separate (cap,cap,C) sweeps
    per step; this runs exactly 2).

    Returns ``(values_fn, force_fn)``:
      values_fn(state) -> (s_stack, terms)
      force_fn(state, terms, dVds) -> (3, Npad) bias force g
    Requires every cv to implement the roll-sweep protocol
    (pair_value_terms / finalize_value / grad_aux / pair_grad_terms).
    """
    def values_fn(state):
        stacks = _half_partner_stacks(state, spec)

        def per_pair(dx, dy, dz, r2, w):
            return tuple(cv.pair_value_terms(dx, dy, dz, r2, w)
                         for cv in cvs)

        terms = _offset_pair_sweep(state, spec, per_pair, half=True,
                                   stacks=stacks)
        s = jnp.stack([cv.finalize_value(t) for cv, t in zip(cvs, terms)])
        return s, (terms, stacks)

    def force_fn(state, ctx, dVds):
        terms, stacks = ctx
        auxs = [cv.grad_aux(t, dVds[i])
                for i, (cv, t) in enumerate(zip(cvs, terms))]

        def pair_grad(dx, dy, dz, r2):
            gx = gy = gz = jnp.float32(0.0)
            for cv, aux in zip(cvs, auxs):
                ax, ay, az = cv.pair_grad_terms(dx, dy, dz, r2, aux)
                gx, gy, gz = gx + ax, gy + ay, gz + az
            return gx, gy, gz

        return _offset_force_sweep(state, spec, pair_grad, stacks=stacks)

    return values_fn, force_fn


def _table_pairs(state: PackedState, spec: PackedSpec, tbl):
    """Pair geometry over the slot neighbor table (ops/neighbor_table):
    (dx (3,K,Npad), r2 (K,Npad), w (K,Npad)) — exactly the real pairs,
    minimum-imaged (valid for r_nb < L/2, orthorhombic)."""
    npad = spec.n_pad
    rp = jnp.concatenate(
        [state.r, jnp.zeros((3, 1), state.r.dtype)], axis=1)
    xj = rp[:, tbl]                               # (3, K, Npad)
    dx = state.r[:, None, :] - xj
    Lb = state.box.L[:, None, None]
    dx = dx - Lb * jnp.round(dx / Lb)
    r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
    w = (tbl < npad).astype(jnp.float32)
    return dx, r2, w


def make_table_order_force(cvs, spec: PackedSpec):
    """Neighbor-table twin of :func:`make_fused_order_force` — the
    roll-sweep masks ~96% padding at liquid density; the table path
    gathers only real pairs.

    Returns ``(values_fn, force_fn)``:
      values_fn(state, tbl) -> (s_stack, terms)
      force_fn(state, tbl, terms, dVds) -> (3, Npad) bias force
    Full-table enumeration: each unordered pair appears from both sides
    with weight 1 — the same ordered-pair totals as the Newton-halved
    roll sweep (weight 2), and the parity factor folded by
    ``grad_aux`` applies unchanged (each slot sums only its own side).
    """
    def values_fn(state, tbl):
        dx, r2, w = _table_pairs(state, spec, tbl)
        terms = tuple(cv.pair_value_terms(dx[0], dx[1], dx[2], r2, w)
                      for cv in cvs)
        s = jnp.stack([cv.finalize_value(t) for cv, t in zip(cvs, terms)])
        return s, terms

    def force_fn(state, tbl, terms, dVds):
        dx, r2, w = _table_pairs(state, spec, tbl)
        gx = gy = gz = jnp.float32(0.0)
        for i, (cv, t) in enumerate(zip(cvs, terms)):
            aux = cv.grad_aux(t, dVds[i])
            ax, ay, az = cv.pair_grad_terms(dx[0], dx[1], dx[2], r2, aux)
            gx, gy, gz = gx + ax, gy + ay, gz + az
        return jnp.stack([jnp.sum(w * g, axis=0) for g in (gx, gy, gz)])

    return values_fn, force_fn
