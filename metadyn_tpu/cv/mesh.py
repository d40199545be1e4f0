"""Mesh order parameter / structure-factor CV — particle-mesh + FFT.

Reference parity: ``metadynamics/OrderParameterMesh{,GPU}.{h,cc,cu}``
(recalled, SURVEY.md §2a, §3.3): PPPM-style pipeline

    assign:  ρ(mesh) ← Σ_i a(type_i)·W_CIC(r_i)
    FFT:     ρ̂(k) = FFT[ρ]
    value:   s = (1/N²)·Σ_k |ρ̂(k)|²·u(k)

with u(k) a mode/convolution kernel (here: a Gaussian window around a
target |k₀| by default, or arbitrary per-k weights).  cuFFT/kissFFT/dfft
become ``jnp.fft.fftn`` (XLA's FFT); the CUDA scatter/gather kernels
become a differentiable CIC scatter-add — bias forces come from the shared
vjp (gather in reverse mode), matching the reference's mesh-force
back-interpolation (SURVEY.md §3.3).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.state import State, System


def axis_stencil(f: jax.Array, order: int):
    """Per-axis assignment stencil at mesh coordinate ``f`` (grid node g
    sits at f = g + 0.5): ``(base_node_int, [(offset, weight), ...])``.

    order 2 = CIC (trilinear), order 3 = TSC (triangle-shaped cloud,
    quadratic B-spline) — the two schemes the reference's PPPM-style mesh
    OP offers (``OrderParameterMesh``, recalled; SURVEY.md §3.3
    "CIC/TSC").  Weights are pure polynomial functions of the fractional
    offset, so both are differentiable and box-scale-invariant."""
    if order == 2:
        base = jnp.floor(f - 0.5)
        t = f - 0.5 - base                      # weight toward the +1 node
        return base.astype(jnp.int32), [(0, 1.0 - t), (1, t)]
    if order == 3:
        base = jnp.floor(f)                     # nearest node (centers at
        d = f - 0.5 - base                      #   half-integers), |d|≤1/2
        return base.astype(jnp.int32), [
            (-1, 0.5 * (0.5 - d) ** 2),
            (0, 0.75 - d * d),
            (1, 0.5 * (0.5 + d) ** 2)]
    raise ValueError(f"assign order {order} unsupported (2=CIC, 3=TSC)")


def mesh_assign(pos: jax.Array, weights: jax.Array, box, mesh_shape,
                order: int = 2) -> jax.Array:
    """Particle→mesh assignment (CIC order=2 / TSC order=3), differentiable."""
    nx, ny, nz = mesh_shape
    dims = jnp.asarray([nx, ny, nz], jnp.float32)
    # fractional coordinates: pos/L orthorhombic, h⁻¹·pos triclinic (the
    # mesh is a lattice-aligned grid either way — the window weights are
    # pure fractional functions, so the assignment generalizes unchanged)
    from ..core.box import fractional
    frac = (fractional(pos, box) + 0.5) * dims  # (N, 3) mesh coords
    ax = [axis_stencil(frac[:, d], order) for d in range(3)]
    rho = jnp.zeros((nx, ny, nz), jnp.float32)
    dims_i = (nx, ny, nz)
    for cx, wx in ax[0][1]:
        for cy, wy in ax[1][1]:
            for cz, wz in ax[2][1]:
                w = weights * wx * wy * wz
                idx = [jnp.mod(ax[d][0] + c, dims_i[d])
                       for d, c in enumerate((cx, cy, cz))]
                rho = rho.at[idx[0], idx[1], idx[2]].add(w)
    return rho


def cic_assign(pos: jax.Array, weights: jax.Array, box, mesh_shape) -> jax.Array:
    """Cloud-in-cell (trilinear) particle→mesh assignment, differentiable."""
    return mesh_assign(pos, weights, box, mesh_shape, order=2)


def _k_vectors(mesh_shape, box_L):
    ks = [2.0 * np.pi * np.fft.fftfreq(n, d=1.0) * n / l
          for n, l in zip(mesh_shape, box_L)]
    kx, ky, kz = np.meshgrid(*ks, indexing="ij")
    return np.sqrt(kx**2 + ky**2 + kz**2).astype(np.float32)


@struct.dataclass
class MeshOrderParameter:
    """``cv.mesh(nx, ny, nz, mode={type: coef}, k0=..., width=...)``.

    s = (1/N) Σ_k |ρ̂(k)|² u(k), with u(k) = exp(−(|k|−k₀)²/2w²) (k=0
    excluded) or an explicit (nx,ny,nz) weight array.
    """

    mode: jax.Array                 # (n_types,) per-type assignment coef
    u_k: Optional[jax.Array]        # explicit (nx,ny,nz) kernel (box-fixed)
    k0: float = struct.field(pytree_node=False)      # Gaussian window target
    width: float = struct.field(pytree_node=False)   # Gaussian window width
    mesh_shape: tuple = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="mesh")
    assign_order: int = struct.field(pytree_node=False, default=2)

    @classmethod
    def create(cls, mesh_shape, box_L, mode, k0: Optional[float] = None,
               width: float = 0.5, u_k: Optional[np.ndarray] = None,
               name: str = "mesh",
               assign_order: int = 2) -> "MeshOrderParameter":
        """With ``k0``/``width`` (the default), u(|k|) is a Gaussian window
        evaluated at the CURRENT box's k-vectors every step — the CV
        follows the box under NPT exactly like the reference's per-box
        influence function, and the k-space virial is analytic.  An
        explicit ``u_k`` array is box-FIXED (pure fractional-mode weights):
        scale-invariant, zero virial.  ``box_L`` is unused in the Gaussian
        mode (kept for signature compatibility)."""
        mesh_shape = tuple(int(x) for x in mesh_shape)
        if u_k is None:
            assert k0 is not None, "give k0 (target |k|) or an explicit u_k"
        return cls(mode=jnp.asarray(np.asarray(mode, np.float32)),
                   u_k=None if u_k is None
                       else jnp.asarray(np.asarray(u_k, np.float32)),
                   k0=None if k0 is None else float(k0),
                   width=float(width),
                   mesh_shape=mesh_shape, name=name,
                   assign_order=int(assign_order))

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _kernels(self, box) -> tuple[jax.Array, jax.Array]:
        """(u_k, vir_k) at the current box.  vir_k is the PER-AXIS stack
        (3, nx, ny, nz): vir_d = u'(|k|)·k_d²/|k| (trace = u'(|k|)·|k|)."""
        if self.u_k is not None:
            return self.u_k, jnp.zeros((3,) + self.mesh_shape, jnp.float32)
        ms = [np.fft.fftfreq(n_) * n_ for n_ in self.mesh_shape]  # static
        mgrid = np.meshgrid(*ms, indexing="ij")
        if box.tilt is None:
            kd2 = jnp.stack([
                (2.0 * jnp.pi * jnp.asarray(m, jnp.float32) / box.L[d]) ** 2
                for d, m in enumerate(mgrid)])               # (3, nx, ny, nz)
        else:
            # triclinic: k(m) = 2π·(m @ h⁻¹); kd2 holds the Cartesian
            # components squared so kmag is exact for the tilted cell
            # (the per-axis virial split below is only used orthorhombic —
            # see bias_virial)
            from ..core.box import reciprocal_matrix
            B = reciprocal_matrix(box)                       # (3, 3)
            mg = [jnp.asarray(m, jnp.float32) for m in mgrid]
            kd2 = jnp.stack([
                (2.0 * jnp.pi
                 * (mg[0] * B[0, d] + mg[1] * B[1, d] + mg[2] * B[2, d]))
                ** 2
                for d in range(3)])
        kmag = jnp.sqrt(jnp.sum(kd2, axis=0))
        u = jnp.exp(-0.5 * ((kmag - self.k0) / self.width) ** 2)
        uprime = -((kmag - self.k0) / self.width**2) * u
        safe = jnp.where(kmag > 0.0, kmag, 1.0)
        vir = uprime[None] * kd2 / safe
        # exclude the k=0 (total density) mode
        u = jnp.where(kmag == 0.0, 0.0, u)
        vir = jnp.where(kmag[None] == 0.0, 0.0, vir)
        return u, vir

    def _rho_k2(self, state: State, system: System) -> jax.Array:
        w = self.mode[system.types]
        rho = mesh_assign(state.pos, w, state.box, self.mesh_shape,
                          order=self.assign_order)
        return jnp.abs(jnp.fft.fftn(rho)) ** 2

    def value(self, state: State, system: System) -> jax.Array:
        n = state.pos.shape[0]
        u, _ = self._kernels(state.box)
        return jnp.sum(self._rho_k2(state, system) * u) / n

    def bias_virial(self, state: State, system: System,
                    dVds: jax.Array) -> jax.Array:
        """Per-axis (3,) k-space virial of the bias force: under the
        per-axis strain L_d→(1+ε_d)L_d, ρ̂ at fixed integer mode is
        invariant (CIC weights are pure fractional-coordinate functions),
        so the only ε_d-dependence is k_d → k_d/(1+ε_d) inside u:
        W_d = dVds·(1/N)·Σ_k |ρ̂|²·u'(|k|)·k_d²/|k|  (SURVEY.md §3.3).
        The trace recovers the uniform-scaling virial; without it, NPT +
        mesh-CV bias samples the wrong pressure.  Orthorhombic only: a
        per-axis strain of a tilted cell mixes tilt DOF into k, which this
        split does not model (triclinic mesh runs NVT/NVE)."""
        assert state.box.tilt is None, (
            "mesh bias_virial (NPT coupling) requires an orthorhombic box")
        n = state.pos.shape[0]
        _, vir = self._kernels(state.box)
        return dVds * jnp.sum(self._rho_k2(state, system)[None] * vir,
                              axis=(1, 2, 3)) / n
