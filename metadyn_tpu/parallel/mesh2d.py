"""Pencil-decomposed particle-mesh FFT for the S(k) CV on the 2-D mesh.

Reference parity: ``OrderParameterMeshGPU`` + dfftlib under a 3-D MPI
sub-box decomposition (recalled, SURVEY.md §2b cuFFT/dfft row, §3.3).
The 1-D slab FFT (parallel/mesh.py) pairs with the slab engine; this
module pairs with the 2-D ``("spacex", "spacey")`` cell decomposition
(parallel/spatial2d.py) — without it, Config-5-style S(k) runs are
pinned to 1-D meshes.

Design (the classic 2-D pencil transpose scheme):

1. **Local CIC/TSC assignment with 2-D halo shells.**  Each device
   assigns its own (cap, cx_l, cy_l, cz) slot block into a local ρ block
   of ``(nx_l + 2hx, ny_l + 2hy, nz)`` — z-pencils with halo shells on
   the two sharded mesh axes.  The halos fold into the neighbors with
   the two-hop reverse of the force path's ghost extension: x-halos
   first (keeping the extended y axis, so corner mass rides into the
   x-neighbor's y-halo), then y-halos of the x-interior — 4 ring
   ``ppermute``s total, no corner messages.  After the folds ρ is
   exactly the global mesh, sharded in (x, y) pencils.

2. **Pencil FFT with two all-to-all transposes** (the dfft butterfly,
   one per sharded axis):  FFT over z locally → ``all_to_all`` over
   ``spacey`` (split z, gather y) → FFT over y locally → ``all_to_all``
   over ``spacex`` (split y, gather x) → FFT over x locally.  ρ̂ comes
   out with y sharded over ``spacex`` and z over ``spacey``; the
   |ρ̂|²·u(k) reduction runs on each device's (y, z) k-tile and is
   ``psum``-finished over both axes.

Forces come from the shared vjp through the whole pipeline (shard_map
is differentiable; the scatter transposes to the gather interpolation,
each all_to_all to its reverse — the reference's force
back-interpolation, SURVEY.md §3.3).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from ..utils import struct

from ..core.state import System
from ..ops.packed import PackedSpec, PackedState
from .spatial import _shard_map
from .spatial2d import _ring
from ..cv.mesh import axis_stencil


@struct.dataclass
class ShardedPackedMesh2D:
    """Mesh order parameter on the (x, y)-sharded packed state (cf.
    parallel/mesh.ShardedPackedMesh — same math, pencil decomposition).

    Use with ``parallel.spatial2d.SpatialPackedEngine2D`` (the slot
    blocks and the ρ pencils share the ``("spacex", "spacey")`` axes).
    Gaussian-window kernel u(|k|) only (the NPT-correct mode).
    """

    k0: float = struct.field(pytree_node=False)
    width: float = struct.field(pytree_node=False)
    mesh_shape: tuple = struct.field(pytree_node=False)
    n_real: int = struct.field(pytree_node=False)
    spec: PackedSpec = struct.field(pytree_node=False)
    mesh: Mesh = struct.field(pytree_node=False)
    axes: tuple = struct.field(pytree_node=False,
                               default=("spacex", "spacey"))
    halo: tuple = struct.field(pytree_node=False, default=(2, 2))
    name: str = struct.field(pytree_node=False, default="mesh")
    assign_order: int = struct.field(pytree_node=False, default=2)
    # nested=True: build the FFT island for use INSIDE an enclosing
    # shard_map (walkers x 2-D space) — only ``axes`` go manual here
    nested: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, mesh_shape, spec: PackedSpec, mesh: Mesh, n_real: int,
               k0: float, width: float = 0.5,
               axes=("spacex", "spacey"), box_L=None, name: str = "mesh",
               assign_order: int = 2,
               nested: bool = False) -> "ShardedPackedMesh2D":
        mesh_shape = tuple(int(x) for x in mesh_shape)
        nx, ny, nz = mesh_shape
        n_x, n_y = mesh.shape[axes[0]], mesh.shape[axes[1]]
        assert nx % n_x == 0 and ny % n_y == 0, (
            f"mesh dims ({nx},{ny}) must divide over the ({n_x},{n_y}) "
            "mesh")
        # transpose divisibility: the z→y all_to_all splits z over n_y,
        # the y→x one splits y over n_x
        assert nz % n_y == 0 and ny % n_x == 0, (
            f"pencil transposes need nz % {n_y} == 0 and ny % {n_x} == 0 "
            f"(got nz={nz}, ny={ny})")
        # halo width per sharded axis: assignment cloud (1 column — both
        # windows span at most floor(f)±1, see parallel/mesh.py) + max
        # drift between repacks (half-skin) in mesh columns
        halos = []
        for d, (n_d, n_dev) in enumerate(((nx, n_x), (ny, n_y))):
            if box_L is not None:
                # per-axis box length: a scalar box_L broadcasts, a
                # 3-vector uses component d (non-cubic boxes must size the
                # y halo from Ly — assignment uses f = r[d]/box_L[d])
                bl = np.asarray(box_L, dtype=np.float64).reshape(-1)
                spacing = float(bl[d] if bl.size > 1 else bl[0]) / n_d
                h = 1 + int(np.ceil((0.5 * spec.skin) / spacing))
            else:
                h = 2
            assert h <= n_d // n_dev, (
                f"halo {h} exceeds local extent {n_d // n_dev} on axis "
                f"{d}; use a coarser mesh or fewer devices")
            halos.append(h)
        return cls(k0=float(k0), width=float(width), mesh_shape=mesh_shape,
                   n_real=n_real, spec=spec, mesh=mesh, axes=tuple(axes),
                   halo=tuple(halos), name=name,
                   assign_order=int(assign_order), nested=nested)

    @property
    def attr_name(self) -> str:
        return f"mesh_{self.name}"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _local_fn(self, weight_kind: str):
        """Per-device body ``local(r, w, box_L, six, siy) -> psummed
        partial`` (UN-normalized).  Shared by the forward islands and
        :meth:`accum_bias_force`, which differentiates it INSIDE the
        island (see parallel/mesh.py — nested-island AD transpose trips
        a Shardy manual-axis-ordering limit, so the shard_map boundary
        itself is never transposed)."""
        spec = self.spec
        nx, ny, nz = self.mesh_shape
        ax, ay = self.axes
        n_x, n_y = self.mesh.shape[ax], self.mesh.shape[ay]
        nx_l, ny_l = nx // n_x, ny // n_y
        hx, hy = self.halo
        cx, cy, cz = spec.cells_per_dim
        assert cx % n_x == 0 and cy % n_y == 0
        order = self.assign_order
        k0, width = self.k0, self.width
        fwd_x, bwd_x = _ring(n_x)
        fwd_y, bwd_y = _ring(n_y)

        def local(r, w, box_L, six, siy):
            """r (3, cap, cx_l, cy_l, cz) slot block, w its coefficients."""
            ix, iy = six[0], siy[0]
            x0, y0 = ix * nx_l, iy * ny_l

            # --- local assignment into the halo-extended pencil ---------
            st = []
            for d, n_d in enumerate((nx, ny, nz)):
                f = (r[d].reshape(-1) / box_L[d] + 0.5) * n_d
                st.append(axis_stencil(f, order))
            rho_e = jnp.zeros((nx_l + 2 * hx) * (ny_l + 2 * hy) * nz,
                              jnp.float32)
            wf = w.reshape(-1)
            nye = ny_l + 2 * hy
            for cx_, wx in st[0][1]:
                for cy_, wy in st[1][1]:
                    for cz_, wz in st[2][1]:
                        ww = wf * wx * wy * wz
                        # x/y: LOCAL extended indices, no global mod (a
                        # seam particle maps into the halo shell; the
                        # ring folds handle the global wrap); z: global
                        lx = st[0][0] + cx_ - x0 + hx
                        ly = st[1][0] + cy_ - y0 + hy
                        iz = jnp.mod(st[2][0] + cz_, nz)
                        rho_e = rho_e.at[
                            (lx * nye + ly) * nz + iz].add(ww, mode="drop")
            rho_e = rho_e.reshape(nx_l + 2 * hx, nye, nz)

            # --- two-hop halo folds (reverse of the ghost extension) ----
            # x first, carrying the full extended-y extent so corner mass
            # lands in the x-neighbor's y-halo; then y on the x-interior.
            from_right = jax.lax.ppermute(rho_e[:hx], ax, bwd_x)
            from_left = jax.lax.ppermute(rho_e[-hx:], ax, fwd_x)
            rho = rho_e[hx:-hx]
            rho = rho.at[-hx:].add(from_right)
            rho = rho.at[:hx].add(from_left)      # (nx_l, nye, nz)
            from_up = jax.lax.ppermute(rho[:, :hy], ay, bwd_y)
            from_down = jax.lax.ppermute(rho[:, -hy:], ay, fwd_y)
            rho = rho[:, hy:-hy]
            rho = rho.at[:, -hy:].add(from_up)
            rho = rho.at[:, :hy].add(from_down)   # (nx_l, ny_l, nz) exact

            # --- pencil FFT: z local, transpose, y local, transpose, x --
            rk = jnp.fft.fft(rho.astype(jnp.complex64), axis=2)
            # z-pencils → y-pencils: gather y, split z over "spacey"
            rk = jax.lax.all_to_all(rk, ay, split_axis=2, concat_axis=1,
                                    tiled=True)   # (nx_l, ny, nz/n_y)
            rk = jnp.fft.fft(rk, axis=1)
            # y-pencils → x-pencils: gather x, split y over "spacex"
            rk = jax.lax.all_to_all(rk, ax, split_axis=1, concat_axis=0,
                                    tiled=True)   # (nx, ny/n_x, nz/n_y)
            rk = jnp.fft.fft(rk, axis=0)

            # --- k-space reduction over my (y, z) k-tile ----------------
            mx = jnp.asarray(np.fft.fftfreq(nx) * nx, jnp.float32)
            my_full = jnp.asarray(np.fft.fftfreq(ny) * ny, jnp.float32)
            mz_full = jnp.asarray(np.fft.fftfreq(nz) * nz, jnp.float32)
            my = jax.lax.dynamic_slice(my_full, (ix * (ny // n_x),),
                                       (ny // n_x,))
            mz = jax.lax.dynamic_slice(mz_full, (iy * (nz // n_y),),
                                       (nz // n_y,))
            kmag = 2.0 * jnp.pi * jnp.sqrt(
                (mx[:, None, None] / box_L[0]) ** 2
                + (my[None, :, None] / box_L[1]) ** 2
                + (mz[None, None, :] / box_L[2]) ** 2)
            u = jnp.exp(-0.5 * ((kmag - k0) / width) ** 2)
            if weight_kind == "virial":
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
            return jax.lax.psum(part, (ax, ay))

        return local

    def _island(self, body, extra_specs=(), out_specs=None):
        """shard_map the per-device ``body`` (nested-aware) and return a
        caller feeding the (r, w, box_L, iota_x, iota_y, *extra) views."""
        ax, ay = self.axes
        n_x, n_y = self.mesh.shape[ax], self.mesh.shape[ay]
        fn = _shard_map(
            body, None if self.nested else self.mesh,
            in_specs=(P(None, None, ax, ay, None), P(None, ax, ay, None),
                      P(), P(ax), P(ay)) + tuple(extra_specs),
            out_specs=P() if out_specs is None else out_specs,
            axis_names=(ax, ay) if self.nested else None)
        iota_x = jnp.arange(n_x, dtype=jnp.int32)
        iota_y = jnp.arange(n_y, dtype=jnp.int32)

        def run(state, *extra):
            cap = self.spec.cap
            cx, cy, cz = self.spec.cells_per_dim
            args = (state.r.reshape(3, cap, cx, cy, cz),
                    state.attrs[self.attr_name].reshape(cap, cx, cy, cz),
                    state.box.L, iota_x, iota_y) + extra
            if self.nested:
                # inside the enclosing (walker-manual) region the island
                # inlines directly
                return fn(*args)
            # jit so eager callers (sampler init) get automatic input
            # resharding; inside an outer jit this inlines
            return jax.jit(fn)(*args)

        return run

    def _sharded_sum(self, state: PackedState, weight_kind: str) -> jax.Array:
        """(1/N)·Σ_k |ρ̂(k)|²·w(k) with w = u (value) or the per-axis
        virial stack, fully partitioned (see module docstring)."""
        s = self._island(self._local_fn(weight_kind))(state)
        return s / self.n_real

    def accum_bias_force(self, state: PackedState, system, dVds: jax.Array,
                         f_acc: jax.Array) -> jax.Array:
        """f_acc += −dVds·∂s/∂r — k-space force back-interpolation
        (SURVEY.md §3.3) by differentiating the local pipeline inside
        the island (parallel/mesh.py parity)."""
        local = self._local_fn("value")
        ax, ay = self.axes

        def local_grad(r, w, box_L, six, siy, cot):
            val, vjp = jax.vjp(
                lambda rr: local(rr, w, box_L, six, siy), r)
            # imprint val's varying-manual-axes type on the replicated
            # cotangent (see parallel/mesh.py)
            (gr,) = vjp(cot + 0.0 * val)
            return gr

        cot = (-dVds / self.n_real).astype(jnp.float32)
        g = self._island(local_grad, extra_specs=(P(),),
                         out_specs=P(None, None, ax, ay, None))(state, cot)
        return f_acc + g.reshape(3, -1)

    def value(self, state: PackedState, system: System) -> jax.Array:
        return self._sharded_sum(state, "value")

    def bias_virial(self, state: PackedState, system: System,
                    dVds: jax.Array) -> jax.Array:
        """Per-axis k-space virial W_d = dVds·(1/N)Σ|ρ̂|²u'(|k|)k_d²/|k|
        (cv/mesh.py)."""
        return dVds * self._sharded_sum(state, "virial")
