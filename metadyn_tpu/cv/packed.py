"""Collective variables over the packed (slot-layout) state.

Same math as the particle-order CVs (cv/lamellar.py etc.), evaluated
directly on the SoA slot arrays — no unpacking gathers in the hot loop.
Per-type amplitudes are carried as per-slot attributes (scattered at
pack/repack time), so vacant slots contribute exactly zero.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.box import reciprocal_matrix
from ..core.state import System
from ..ops.packed import PackedState, _cart3, _frac3


@struct.dataclass
class PackedLamellar:
    """Lamellar order parameter on packed state (cf. cv/lamellar.py):

        s = (1/N) Σ_slots amp_slot · cos(k_j·r_slot + φ_j)

    ``amp`` must be registered as a per-slot attribute named
    ``lam_<name>`` at pack time (mode coefficient per particle; 0 vacant).
    """

    lattice_vectors: jax.Array  # (M, 3) integer Miller indices
    phases: jax.Array           # (M,)
    n_real: int = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="lamellar")

    @classmethod
    def create(cls, lattice_vectors, n_real, phases=None, name="lamellar"):
        lv = np.asarray(lattice_vectors, np.float32).reshape(-1, 3)
        ph = np.zeros(lv.shape[0], np.float32) if phases is None else \
            np.asarray(phases, np.float32)
        return cls(lattice_vectors=jnp.asarray(lv), phases=jnp.asarray(ph),
                   n_real=n_real, name=name)

    @property
    def attr_name(self) -> str:
        return f"lam_{self.name}"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: PackedState, system: System) -> jax.Array:
        amp = state.attrs[self.attr_name]           # (Npad,)
        # k(n) = 2π·(n @ h⁻¹): orthorhombic ⇒ 2π n/L; triclinic ⇒ the
        # reciprocal-matrix wave vectors (cv/lamellar.py parity)
        k = 2.0 * jnp.pi * jnp.matmul(self.lattice_vectors,
                              reciprocal_matrix(state.box),
                              precision="highest")
        # phase per (mode, slot): SoA contraction, no (Npad, 3) layout
        s = jnp.float32(0.0)
        for m in range(self.lattice_vectors.shape[0]):
            phase = (k[m, 0] * state.r[0] + k[m, 1] * state.r[1]
                     + k[m, 2] * state.r[2] + self.phases[m])
            s = s + jnp.sum(amp * jnp.cos(phase))
        return s / self.n_real

    def accum_bias_force(self, state: PackedState, system: System,
                         dVds: jax.Array, f_acc: jax.Array) -> jax.Array:
        """Hot-path analytic bias force: f_acc += −dVds · ∂s/∂r.

        ∂s/∂r_d = −amp·sin(k·r+φ)·k_d / N, so the contribution is
        +dVds·amp·sin(phase)·k_d/N — a fused SoA elementwise pass (no vjp
        re-trace; oracle-tested against jax.vjp in tests/test_cvs.py)."""
        amp = state.attrs[self.attr_name]
        k = 2.0 * jnp.pi * jnp.matmul(self.lattice_vectors,
                              reciprocal_matrix(state.box),
                              precision="highest")
        coef = dVds / self.n_real
        for m in range(self.lattice_vectors.shape[0]):
            phase = (k[m, 0] * state.r[0] + k[m, 1] * state.r[1]
                     + k[m, 2] * state.r[2] + self.phases[m])
            w = coef * amp * jnp.sin(phase)          # (Npad,)
            f_acc = f_acc + w[None, :] * k[m, :, None]
        return f_acc


@struct.dataclass
class PackedMSD:
    """Mean-squared displacement CV on packed state (cf. reference MSD CV,
    SURVEY.md §2a): s = (1/N) Σ |r_unwrapped − r₀|².  Reference positions
    are per-slot attributes ``msd_x/y/z`` (unwrapped, repacked with slots)."""

    n_real: int = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="msd")

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: PackedState, system: System) -> jax.Array:
        valid = (state.pid < self.n_real).astype(jnp.float32)
        # unwrap = r + h·image (image counts LATTICE vectors; ortho ⇒ r+L·im)
        uw = state.r + _cart3(state.image.astype(jnp.float32), state.box)
        s = jnp.float32(0.0)
        for d, nm in enumerate(("msd_x", "msd_y", "msd_z")):
            diff = (uw[d] - state.attrs[nm]) * valid
            s = s + jnp.sum(diff * diff)
        return s / self.n_real

    def accum_bias_force(self, state: PackedState, system: System,
                         dVds: jax.Array, f_acc: jax.Array) -> jax.Array:
        """f_acc += −dVds · ∂s/∂r with ∂s/∂r_d = 2(r_d − r⁰_d)/N."""
        valid = (state.pid < self.n_real).astype(jnp.float32)
        coef = -2.0 * dVds / self.n_real
        uw = state.r + _cart3(state.image.astype(jnp.float32), state.box)
        rows = []
        for d, nm in enumerate(("msd_x", "msd_y", "msd_z")):
            rows.append(coef * (uw[d] - state.attrs[nm]) * valid)
        return f_acc + jnp.stack(rows)

    def bias_virial(self, state: PackedState, system: System,
                    dVds: jax.Array) -> jax.Array:
        """Per-axis W_d = −dVds·(2/N)·Σ (u_d−r⁰_d)·u_d (see cv/msd.py)."""
        valid = (state.pid < self.n_real).astype(jnp.float32)
        uw = state.r + _cart3(state.image.astype(jnp.float32), state.box)
        acc = []
        for d, nm in enumerate(("msd_x", "msd_y", "msd_z")):
            acc.append(jnp.sum((uw[d] - state.attrs[nm]) * uw[d] * valid))
        return -dVds * 2.0 * jnp.stack(acc) / self.n_real


def msd_reference_attrs(pos: np.ndarray) -> dict:
    """Per-particle reference-position attributes for PackedMSD at pack time."""
    p = np.asarray(pos, np.float32)
    return {"msd_x": p[:, 0], "msd_y": p[:, 1], "msd_z": p[:, 2]}


@struct.dataclass
class PackedMesh:
    """Mesh order parameter / S(k) CV on packed state (cf. cv/mesh.py).

    CIC assignment reads the SoA slot arrays directly; per-slot assignment
    coefficients live in the ``mesh_<name>`` attribute (0 on vacant slots).
    """

    u_k: Optional[jax.Array]   # explicit kernel (box-fixed) or None
    k0: float = struct.field(pytree_node=False)
    width: float = struct.field(pytree_node=False)
    mesh_shape: tuple = struct.field(pytree_node=False)
    n_real: int = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="mesh")
    assign_order: int = struct.field(pytree_node=False, default=2)

    @classmethod
    def create(cls, mesh_shape, box_L, n_real, k0=None, width=0.5,
               u_k=None, name="mesh", assign_order=2):
        """Gaussian-window mode (k0/width): u evaluated at the CURRENT
        box's k-vectors (NPT-correct, analytic k-space virial); explicit
        u_k: box-fixed fractional-mode weights (zero virial).  See
        cv/mesh.py."""
        mesh_shape = tuple(int(x) for x in mesh_shape)
        if u_k is None:
            assert k0 is not None
        return cls(u_k=None if u_k is None
                       else jnp.asarray(np.asarray(u_k, np.float32)),
                   k0=None if k0 is None else float(k0),
                   width=float(width),
                   mesh_shape=mesh_shape, n_real=n_real, name=name,
                   assign_order=int(assign_order))

    def _kernels(self, box):
        """(u, vir) with vir the per-axis stack (3, nx, ny, nz):
        vir_d = u'(|k|)·k_d²/|k| (see cv/mesh.py)."""
        if self.u_k is not None:
            return self.u_k, jnp.zeros((3,) + self.mesh_shape, jnp.float32)
        ms = [np.fft.fftfreq(n_) * n_ for n_ in self.mesh_shape]
        mgrid = np.meshgrid(*ms, indexing="ij")
        if box.tilt is None:
            kd2 = jnp.stack([
                (2.0 * jnp.pi * jnp.asarray(m, jnp.float32) / box.L[d]) ** 2
                for d, m in enumerate(mgrid)])
        else:
            # triclinic: k(m) = 2π·(m @ h⁻¹) — exact |k| at the tilted
            # cell (cv/mesh.py parity); per-axis virial split is only
            # consumed by the orthorhombic NPT path
            B = reciprocal_matrix(box)
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
        u = jnp.where(kmag == 0.0, 0.0, u)
        vir = jnp.where(kmag[None] == 0.0, 0.0, vir)
        return u, vir

    @property
    def attr_name(self) -> str:
        return f"mesh_{self.name}"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _rho_k2(self, state: PackedState) -> jax.Array:
        nx, ny, nz = self.mesh_shape
        w = state.attrs[self.attr_name]
        rho = jnp.zeros(nx * ny * nz, jnp.float32)
        # per-axis mesh coords from SoA components (no (Npad, 3) array);
        # assignment is FRACTIONAL (lattice-aligned CIC/TSC stencils,
        # cv/mesh.axis_stencil), so the same code covers tilted cells
        # (cv/mesh.py parity)
        from .mesh import axis_stencil
        f3 = _frac3(state.r, state.box)
        ax = [axis_stencil((f3[d] + 0.5) * n_d, self.assign_order)
              for d, n_d in enumerate((nx, ny, nz))]
        for cx_, wx in ax[0][1]:
            for cy_, wy in ax[1][1]:
                for cz_, wz in ax[2][1]:
                    ww = w * wx * wy * wz
                    ix = jnp.mod(ax[0][0] + cx_, nx)
                    iy = jnp.mod(ax[1][0] + cy_, ny)
                    iz = jnp.mod(ax[2][0] + cz_, nz)
                    rho = rho.at[(ix * ny + iy) * nz + iz].add(ww)
        rho_k = jnp.fft.fftn(rho.reshape(nx, ny, nz))
        return jnp.abs(rho_k) ** 2

    def value(self, state: PackedState, system: System) -> jax.Array:
        u, _ = self._kernels(state.box)
        return jnp.sum(self._rho_k2(state) * u) / self.n_real

    def bias_virial(self, state: PackedState, system: System,
                    dVds: jax.Array) -> jax.Array:
        """Per-axis k-space virial W_d = dVds·(1/N)Σ|ρ̂|²u'(|k|)k_d²/|k|
        (see cv/mesh.py)."""
        _, vir = self._kernels(state.box)
        return dVds * jnp.sum(self._rho_k2(state)[None] * vir,
                              axis=(1, 2, 3)) / self.n_real
