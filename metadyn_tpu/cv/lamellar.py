"""Lamellar order parameter CV — direct Fourier sum over fixed wave vectors.

Reference parity: ``metadynamics/LamellarOrderParameter{,GPU}.{h,cc,cu}``
(recalled, SURVEY.md §2a/§3.2):

    s = (1/N) Σ_j Σ_i a(type_i) · cos(k_j·r_i + φ_j),
    k_j = 2π (n_j ∘ 1/L)  for integer lattice vectors n_j.

The CUDA per-particle kernel + block reduction becomes one fused XLA
reduction over an (N, M) phase matrix; forces come from the shared vjp path
(cv/base.py) and match the reference's −sin analytic form by construction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..core.state import State, System


@struct.dataclass
class LamellarOP:
    """Mirrors ``cv.lamellar(mode={type: coef}, lattice_vectors=[...], phi=[...])``."""

    mode: jax.Array             # (n_types,) per-type amplitude a(type)
    lattice_vectors: jax.Array  # (M, 3) integer Miller indices n_j
    phases: jax.Array           # (M,) φ_j
    name: str = struct.field(pytree_node=False, default="lamellar")

    @classmethod
    def create(cls, mode, lattice_vectors, phases=None, name="lamellar") -> "LamellarOP":
        lv = np.asarray(lattice_vectors, np.float32).reshape(-1, 3)
        phases = np.zeros(lv.shape[0], np.float32) if phases is None else np.asarray(phases, np.float32)
        return cls(
            mode=jnp.asarray(np.asarray(mode, np.float32)),
            lattice_vectors=jnp.asarray(lv),
            phases=jnp.asarray(phases),
            name=name,
        )

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> jax.Array:
        if state.box.tilt is None:
            k = 2.0 * jnp.pi * self.lattice_vectors / state.box.L[None, :]
        else:
            # triclinic: k_j = 2π n_j @ h⁻¹ (reciprocal lattice of the
            # tilted cell — see core/box.reciprocal_matrix)
            from ..core.box import reciprocal_matrix
            k = 2.0 * jnp.pi * jnp.matmul(
                self.lattice_vectors, reciprocal_matrix(state.box),
                precision="highest")                            # (M, 3)
        # full f32: a default-precision f32 matmul runs in TF32 on the GPU
        phase = jnp.matmul(state.pos, k.T, precision="highest") \
            + self.phases[None, :]                                      # (N, M)
        amp = self.mode[system.types]                                   # (N,)
        return jnp.sum(amp[:, None] * jnp.cos(phase)) / state.pos.shape[0]
