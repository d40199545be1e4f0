"""Simulation box (orthorhombic or triclinic) and periodic-boundary math.

Reference parity: HOOMD-blue's ``BoxDim`` (minimum image, wrapping, image
counters used by unwrapped coordinates / the MSD CV), INCLUDING its
triclinic parametrization — tilt factors ``(xy, xz, yz)`` define the
upper-triangular cell matrix

    h = [[Lx, xy*Ly, xz*Lz],
         [0,  Ly,    yz*Lz],
         [0,  0,     Lz   ]]

so a lattice point is ``r = h @ f`` with fractional ``f``.  See SURVEY.md
§2b (``BoxDim``/PBC row).

``tilt=None`` (the default) keeps every code path on the orthorhombic fast
math — the triclinic branch is selected STATICALLY at trace time, so
orthorhombic runs compile to exactly the pre-triclinic program.  Triclinic
boxes run on the general engines (all-pairs pair/bond forces, Langevin/NVT
stepping, lamellar/mesh/Steinhardt/MSD CVs), on the packed
cell-decomposition hot path (fractional binning + h-matrix roll shifts,
ops/packed.py; cells sized by perpendicular width), AND — round 5 —
under the 1-D spatial decomposition (the slab axis is fractional x,
whose lattice vector a1 = h·(1,0,0) = (Lx, 0, 0) keeps the ghost seam
shift orthorhombic-shaped; parallel/spatial.py).  The 2-D decomposition,
the distributed-FFT mesh CV, and the packed NPT barostat keep
orthorhombic guards (its NPT couples tilt DOFs separately — out of
scope).

Minimum-image convention under tilt follows HOOMD: round in FRACTIONAL
coordinates — exact whenever the interaction range is below half the
minimum perpendicular width (:func:`min_perpendicular_width`), which the
engines validate at build time.

All functions are pure jnp and shape-static so they fuse into the jitted
MD step.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct


@struct.dataclass
class Box:
    """Periodic box: edge lengths ``L = (Lx, Ly, Lz)`` plus optional HOOMD
    tilt factors ``tilt = (xy, xz, yz)`` (None ⇒ orthorhombic)."""

    L: jax.Array  # (3,) f32
    tilt: Optional[jax.Array] = None  # (3,) f32 = (xy, xz, yz), or None

    @property
    def volume(self) -> jax.Array:
        # det h = Lx*Ly*Lz regardless of tilt (upper triangular)
        return jnp.prod(self.L)

    @property
    def is_triclinic(self) -> bool:
        return self.tilt is not None

    @classmethod
    def cubic(cls, L: float) -> "Box":
        # host-side (numpy) on purpose: later host reads of the box
        # (pack_host, spec sizing) then need no device fetch.  NumPy
        # leaves enter jit like any other input and become device arrays
        # at the single device_put of the packed state.
        return cls(L=np.full((3,), L, dtype=np.float32))

    @classmethod
    def from_lengths(cls, Lx: float, Ly: float, Lz: float) -> "Box":
        return cls(L=np.asarray([Lx, Ly, Lz], dtype=np.float32))

    @classmethod
    def triclinic(cls, Lx: float, Ly: float, Lz: float,
                  xy: float = 0.0, xz: float = 0.0,
                  yz: float = 0.0) -> "Box":
        """HOOMD-convention triclinic box (dimensionless tilt factors)."""
        return cls(L=np.asarray([Lx, Ly, Lz], dtype=np.float32),
                   tilt=np.asarray([xy, xz, yz], dtype=np.float32))


def h_matrix(box: Box) -> jax.Array:
    """(3, 3) upper-triangular cell matrix h (columns = lattice vectors)."""
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    if box.tilt is None:
        return jnp.diag(box.L)
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    z = jnp.zeros_like(Lx)
    return jnp.stack([
        jnp.stack([Lx, xy * Ly, xz * Lz]),
        jnp.stack([z, Ly, yz * Lz]),
        jnp.stack([z, z, Lz]),
    ])


def h_inverse(box: Box) -> jax.Array:
    """Closed-form inverse of the upper-triangular cell matrix."""
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    if box.tilt is None:
        return jnp.diag(1.0 / box.L)
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    z = jnp.zeros_like(Lx)
    return jnp.stack([
        jnp.stack([1.0 / Lx, -xy / Lx, (xy * yz - xz) / Lx]),
        jnp.stack([z, 1.0 / Ly, -yz / Ly]),
        jnp.stack([z, z, 1.0 / Lz]),
    ])


def reciprocal_matrix(box: Box) -> jax.Array:
    """Reciprocal-basis matrix B = h⁻¹: ``k = 2π * (n @ B)`` is the wave
    vector of integer Miller row(s) n, satisfying k·(h f) = 2π n·f.
    Orthorhombic: B = diag(1/L), i.e. k = 2π n / L."""
    return h_inverse(box)


def fractional(pos: jax.Array, box: Box) -> jax.Array:
    """Cartesian (..., 3) → fractional coordinates f = h⁻¹ r.

    Elementwise triangular solve, not a matmul: an f32 matmul may run at
    reduced precision on an accelerator (TF32 on the GPU), whose ~1e-3
    relative error corrupts wrap/bin positions (ops/packed._frac3 has the
    same form)."""
    if box.tilt is None:
        return pos / box.L
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    fz = pos[..., 2] / Lz
    fy = (pos[..., 1] - yz * pos[..., 2]) / Ly
    fx = (pos[..., 0] - xy * (pos[..., 1] - yz * pos[..., 2])
          - xz * pos[..., 2]) / Lx
    return jnp.stack([fx, fy, fz], axis=-1)


def from_fractional(frac: jax.Array, box: Box) -> jax.Array:
    """Fractional (..., 3) → Cartesian r = h f (elementwise triangular
    product — see :func:`fractional`)."""
    if box.tilt is None:
        return frac * box.L
    Lx, Ly, Lz = box.L[0], box.L[1], box.L[2]
    xy, xz, yz = box.tilt[0], box.tilt[1], box.tilt[2]
    r2 = Lz * frac[..., 2]
    r1 = Ly * frac[..., 1] + yz * Lz * frac[..., 2]
    r0 = (Lx * frac[..., 0] + xy * Ly * frac[..., 1]
          + xz * Lz * frac[..., 2])
    return jnp.stack([r0, r1, r2], axis=-1)


def min_perpendicular_width(box: Box) -> jax.Array:
    """(3,) perpendicular widths of the cell (distance between opposite
    faces).  Interaction cutoffs must stay below half the minimum width
    for the fractional-rounding minimum image to be exact."""
    if box.tilt is None:
        return box.L
    h = h_matrix(box)
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    vol = jnp.abs(jnp.dot(a, jnp.cross(b, c)))
    wa = vol / jnp.linalg.norm(jnp.cross(b, c))
    wb = vol / jnp.linalg.norm(jnp.cross(c, a))
    wc = vol / jnp.linalg.norm(jnp.cross(a, b))
    return jnp.stack([wa, wb, wc])


def minimum_image(dr: jax.Array, box: Box) -> jax.Array:
    """Minimum-image convention for displacement vectors ``dr`` (..., 3).

    Triclinic: HOOMD's convention — round in fractional coordinates
    (exact for ranges < half the min perpendicular width)."""
    if box.tilt is None:
        L = box.L
        return dr - L * jnp.round(dr / L)
    f = fractional(dr, box)
    return dr - from_fractional(jnp.round(f), box)


def wrap(pos: jax.Array, box: Box) -> tuple[jax.Array, jax.Array]:
    """Wrap positions into the primary cell (fractional [-1/2, 1/2) per
    lattice axis; orthorhombic ⇒ Cartesian [-L/2, L/2)).

    Returns (wrapped_positions, image_shift) where ``image_shift`` counts
    LATTICE VECTORS removed — add it to an image counter to keep unwrapped
    coordinates (needed by the MSD collective variable)."""
    if box.tilt is None:
        L = box.L
        shift = jnp.floor(pos / L + 0.5).astype(jnp.int32)
        return pos - L * shift.astype(pos.dtype), shift
    f = fractional(pos, box)
    shift = jnp.floor(f + 0.5).astype(jnp.int32)
    return pos - from_fractional(shift.astype(pos.dtype), box), shift


def unwrap(pos: jax.Array, image: jax.Array, box: Box) -> jax.Array:
    """Reconstruct unwrapped coordinates from wrapped positions + images."""
    if box.tilt is None:
        return pos + image.astype(pos.dtype) * box.L
    return pos + from_fractional(image.astype(pos.dtype), box)
