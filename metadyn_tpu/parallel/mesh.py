"""Distributed particle-mesh FFT for the S(k) CV — the dfftlib analog.

Reference parity: ``OrderParameterMeshGPU`` + dfftlib under MPI domain
decomposition (recalled, SURVEY.md §2b cuFFT/dfft row, §3.3): at the
1M-particle DSA scale the mesh assignment, the 3-D FFT, and the k-space
reduction must all run on a *partitioned* mesh, or the mesh CV pins the
whole system onto one chip.

Design (slab decomposition, matching the cell sharding of
``parallel.spatial``):

1. **Local CIC assignment with halo columns.**  Each device assigns its
   own slot slab into a local ρ slab of ``nx/ndev`` x-columns extended by
   ``h`` halo columns per side (particles drift up to half-skin past
   their cells between repacks, and the CIC cloud spans 2 columns).  The
   halo columns are folded into the neighbors with one ``ppermute`` per
   side — after the fold, ρ is *exactly* the global mesh, sharded in
   x-slabs.

2. **Slab FFT with one all-to-all transpose** (the dfft butterfly):
   FFT over (y, z) locally, ``jax.lax.all_to_all`` transposing
   x-gather/y-split over the ``"space"`` axis, FFT over x locally.
   ρ̂ comes out sharded along y; |ρ̂|²·u(k) is reduced locally over each
   device's y-slab of k-vectors and ``psum``-finished.

Forces come from the shared vjp through the whole pipeline (shard_map is
differentiable; the CIC scatter transposes to the gather interpolation,
the FFT to the inverse FFT, the all_to_all to its reverse — exactly the
reference's force back-interpolation path, SURVEY.md §3.3).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from ..utils import struct

from ..core.state import System
from ..ops.packed import PackedSpec, PackedState
from .spatial import _shard_map


@struct.dataclass
class ShardedPackedMesh:
    """Mesh order parameter on the x-sharded packed state (cf.
    cv/packed.py PackedMesh — same math, partitioned execution).

    Use with ``parallel.spatial.SpatialPackedEngine`` (the slot slabs and
    the ρ slabs share the ``"space"`` axis).  Gaussian-window kernel
    u(|k|) only (the NPT-correct mode).
    """

    k0: float = struct.field(pytree_node=False)
    width: float = struct.field(pytree_node=False)
    mesh_shape: tuple = struct.field(pytree_node=False)
    n_real: int = struct.field(pytree_node=False)
    spec: PackedSpec = struct.field(pytree_node=False)
    mesh: Mesh = struct.field(pytree_node=False)
    axis: str = struct.field(pytree_node=False, default="space")
    halo: int = struct.field(pytree_node=False, default=2)
    name: str = struct.field(pytree_node=False, default="mesh")
    assign_order: int = struct.field(pytree_node=False, default=2)
    # nested=True builds the FFT island for use INSIDE an enclosing
    # shard_map (the walkers x space product mesh): only ``axis`` goes
    # manual here, the mesh resolves from the calling context — exactly
    # the spatial engine's nested-island mechanism (parallel/spatial.py)
    nested: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, mesh_shape, spec: PackedSpec, mesh: Mesh, n_real: int,
               k0: float, width: float = 0.5, axis: str = "space",
               box_L=None, name: str = "mesh",
               assign_order: int = 2,
               nested: bool = False) -> "ShardedPackedMesh":
        mesh_shape = tuple(int(x) for x in mesh_shape)
        nx, ny, nz = mesh_shape
        n_dev = mesh.shape[axis]
        assert nx % n_dev == 0 and ny % n_dev == 0, (
            f"mesh dims ({nx},{ny}) must divide over {n_dev} devices")
        # halo width: assignment cloud (1 column — BOTH windows' worst
        # case: CIC writes floor(f−½)+{0,1}, TSC floor(f)+{−1,0,1}; each
        # spans at most floor(f)±1) + max drift between repacks
        # (half-skin) in mesh columns.  box_L sizes it exactly; without
        # it fall back to 2 (assert at call time catches violations).
        if box_L is not None:
            spacing = float(np.asarray(box_L).reshape(-1)[0]) / nx
            h = 1 + int(np.ceil((0.5 * spec.skin) / spacing))
        else:
            h = 2
        assert h <= nx // n_dev, (
            f"halo {h} exceeds local slab {nx // n_dev}; use a coarser "
            "mesh or fewer devices")
        return cls(k0=float(k0), width=float(width), mesh_shape=mesh_shape,
                   n_real=n_real, spec=spec, mesh=mesh, axis=axis,
                   halo=h, name=name, assign_order=int(assign_order),
                   nested=nested)

    @property
    def attr_name(self) -> str:
        return f"mesh_{self.name}"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _local_fn(self, weight_kind: str):
        """The per-device body: ``local(r, w, box_L, six) -> psummed
        partial`` of Σ_k |ρ̂(k)|²·w(k) (UN-normalized).  Shared by the
        value/virial forward islands and the analytic-force island
        (:meth:`accum_bias_force`), which takes its vjp INSIDE the
        shard_map body — the collectives (ppermute folds, all_to_all
        transpose, psum) are differentiated in place, so the shard_map
        boundary itself is never transposed (the nested-island AD
        transpose trips a Shardy manual-axis-ordering limit)."""
        nx, ny, nz = self.mesh_shape
        n_dev = self.mesh.shape[self.axis]
        nx_l, ny_l = nx // n_dev, ny // n_dev
        h = self.halo
        axis = self.axis
        k0, width = self.k0, self.width
        order = self.assign_order
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

        def local(r, w, box_L, six):
            """r (3, cap, C_l), w (cap, C_l) per-slot coefficients.

            The shard index arrives as a P(axis)-sharded iota rather than
            ``jax.lax.axis_index``: axis_index's partition-id lowering
            breaks inside a NESTED shard_map (parallel/spatial.py
            local_force has the same workaround)."""
            idx = six[0]
            x0 = idx * nx_l                      # my first global x-column

            # --- local CIC/TSC into the halo-extended slab --------------
            from ..cv.mesh import axis_stencil
            ax = [axis_stencil((r[d].reshape(-1) / box_L[d] + 0.5) * n_d,
                               order)
                  for d, n_d in enumerate((nx, ny, nz))]
            rho_e = jnp.zeros((nx_l + 2 * h) * ny * nz, jnp.float32)
            wf = w.reshape(-1)
            for cx_, wx in ax[0][1]:
                for cy_, wy in ax[1][1]:
                    for cz_, wz in ax[2][1]:
                        ww = wf * wx * wy * wz
                        # x: LOCAL extended index — no global mod (a
                        # seam-drifted particle maps into the halo; the
                        # ring halo fold handles the global wrap)
                        lx = ax[0][0] + cx_ - x0 + h
                        iy = jnp.mod(ax[1][0] + cy_, ny)
                        iz = jnp.mod(ax[2][0] + cz_, nz)
                        rho_e = rho_e.at[
                            (lx * ny + iy) * nz + iz].add(
                                ww, mode="drop")
            rho_e = rho_e.reshape(nx_l + 2 * h, ny, nz)

            # --- fold halo columns into the neighbors -------------------
            # my left halo block = left neighbor's interior tail; send it
            # left (bwd ring); I receive the right neighbor's left halo
            # and add it to MY interior tail.  Mirrored for the right.
            from_right = jax.lax.ppermute(rho_e[:h], axis, bwd)
            from_left = jax.lax.ppermute(rho_e[-h:], axis, fwd)
            rho = rho_e[h:-h]
            rho = rho.at[-h:].add(from_right)
            rho = rho.at[:h].add(from_left)       # (nx_l, ny, nz) exact

            # --- slab FFT: local (y,z), all-to-all transpose, local x ---
            rk = jnp.fft.fftn(rho.astype(jnp.complex64), axes=(1, 2))
            # (nx_l, ny, nz) → gather x, split y → (nx, ny_l, nz)
            rk = jax.lax.all_to_all(rk, axis, split_axis=1, concat_axis=0,
                                    tiled=True)
            rk = jnp.fft.fft(rk, axis=0)

            # --- k-space reduction over my y-slab -----------------------
            mx = jnp.asarray(np.fft.fftfreq(nx) * nx, jnp.float32)
            my_full = jnp.asarray(np.fft.fftfreq(ny) * ny, jnp.float32)
            my = jax.lax.dynamic_slice(my_full, (idx * ny_l,), (ny_l,))
            mz = jnp.asarray(np.fft.fftfreq(nz) * nz, jnp.float32)
            kmag = 2.0 * jnp.pi * jnp.sqrt(
                (mx[:, None, None] / box_L[0]) ** 2
                + (my[None, :, None] / box_L[1]) ** 2
                + (mz[None, None, :] / box_L[2]) ** 2)
            u = jnp.exp(-0.5 * ((kmag - k0) / width) ** 2)
            if weight_kind == "virial":
                # per-axis stack (3, nx, ny_l, nz): u'(|k|)·k_d²/|k|
                kd2 = jnp.stack([
                    jnp.broadcast_to(
                        (2.0 * jnp.pi * m / box_L[d]) ** 2, kmag.shape)
                    for d, m in enumerate((mx[:, None, None],
                                           my[None, :, None],
                                           mz[None, None, :]))])
                safe = jnp.where(kmag > 0.0, kmag, 1.0)
                u = (-((kmag - k0) / width ** 2) * u / safe)[None] * kd2
                u = jnp.where(kmag[None] == 0.0, 0.0, u)
                part = jnp.sum((rk.real ** 2 + rk.imag ** 2)[None] * u,
                               axis=(1, 2, 3))
            else:
                u = jnp.where(kmag == 0.0, 0.0, u)  # k=0 mode excluded
                part = jnp.sum((rk.real ** 2 + rk.imag ** 2) * u)
            return jax.lax.psum(part, axis)

        return local

    def _island(self, body, extra_specs=(), out_specs=None):
        """shard_map the per-device ``body`` (nested-aware) and return a
        caller that feeds the (r, w, box_L, iota, *extra) views."""
        axis = self.axis
        n_dev = self.mesh.shape[axis]
        fn = _shard_map(
            body, None if self.nested else self.mesh,
            in_specs=(P(None, None, axis), P(None, axis), P(), P(axis))
            + tuple(extra_specs),
            out_specs=P() if out_specs is None else out_specs,
            axis_names=(axis,) if self.nested else None)
        shard_iota = jnp.arange(n_dev, dtype=jnp.int32)

        def run(state, *extra):
            assert state.box.tilt is None, (
                "the distributed slab-FFT mesh CV assigns on Cartesian "
                "axis fractions — triclinic runs use the single-device "
                "PackedMesh (fractional CIC/TSC)")
            cap, C = self.spec.cap, self.spec.n_cells
            args = (state.r.reshape(3, cap, C),
                    state.attrs[self.attr_name].reshape(cap, C),
                    state.box.L, shard_iota) + extra
            if self.nested:
                # inside the enclosing (walker-manual) region the island
                # inlines directly
                return fn(*args)
            # jit so eager callers (sampler init) get automatic input
            # resharding; inside an outer jit this inlines
            return jax.jit(fn)(*args)

        return run

    def _sharded_sum(self, state: PackedState, weight_kind: str) -> jax.Array:
        """(1/N)·Σ_k |ρ̂(k)|²·w(k) with w = u (value) or u'·|k| (virial),
        fully partitioned (see module docstring)."""
        s = self._island(self._local_fn(weight_kind))(state)
        return s / self.n_real

    def accum_bias_force(self, state: PackedState, system, dVds: jax.Array,
                         f_acc: jax.Array) -> jax.Array:
        """f_acc += −dVds·∂s/∂r — the reference's k-space force
        back-interpolation (SURVEY.md §3.3), computed by differentiating
        the LOCAL pipeline inside the island (see :meth:`_local_fn`)."""
        local = self._local_fn("value")
        axis = self.axis

        def local_grad(r, w, box_L, six, cot):
            val, vjp = jax.vjp(lambda rr: local(rr, w, box_L, six), r)
            # `cot + 0·val` imprints val's varying-manual-axes type on the
            # replicated cotangent (nested islands: val varies over the
            # enclosing walker axis, and the vjp demands a matching vma)
            (gr,) = vjp(cot + 0.0 * val)
            return gr

        cot = (-dVds / self.n_real).astype(jnp.float32)
        g = self._island(local_grad, extra_specs=(P(),),
                         out_specs=P(None, None, axis))(state, cot)
        return f_acc + g.reshape(3, -1)

    def value(self, state: PackedState, system: System) -> jax.Array:
        return self._sharded_sum(state, "value")

    def bias_virial(self, state: PackedState, system: System,
                    dVds: jax.Array) -> jax.Array:
        """Per-axis k-space virial W_d = dVds·(1/N)Σ|ρ̂|²u'(|k|)k_d²/|k|
        (cv/mesh.py)."""
        return dVds * self._sharded_sum(state, "virial")
