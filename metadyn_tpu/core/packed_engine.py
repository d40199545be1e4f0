"""PackedEngine — the production engine over the slot-layout state.

Implements the engine protocol of core/engine.py on top of ops/packed.py
and the pair path chosen by ``ops.packed_triton.choose_pair_path`` (the
Triton kernel on the GPU, the XLA roll sweep elsewhere).  This is the
production engine for the baseline perf configs (BASELINE.md Configs
2–5); the particle-order engines remain the small-system / CPU-oracle
path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from ..utils import struct

from .box import Box
from .state import System
from ..ops.packed import (
    PackedSpec, PackedState, repack_incremental, packed_temperature,
    needs_repack,
)
from ..ops.packed_triton import choose_pair_path, pair_force


@struct.dataclass
class PackedAux:
    overflow: jax.Array = struct.field(default_factory=lambda: jnp.asarray(False))
    stale: jax.Array = struct.field(default_factory=lambda: jnp.asarray(False))
    # slot neighbor table for the order-CV hot path (ops/neighbor_table);
    # None unless the engine was built with nbr_table=(r_nb, K)
    nbr: Optional[jax.Array] = None


class PackedEngine:
    """LJ (Lorentz–Berthelot) pair forces on the packed cell layout.

    Slot migration is DISTANCE-TRIGGERED like HOOMD's neighbor list: every
    ``rebuild_every`` (default 1) steps the half-skin displacement check
    runs on device and a ``lax.cond`` executes the incremental repack only
    when needed.  A fixed cadence is NOT safe: the thermal velocity tail
    routinely breaks any affordable skin margin, pairs get missed, and the
    resulting overlaps inject energy in a runaway feedback (observed at
    64k: vmax creep 5 → 40 → explosion within 500 steps)."""

    def __init__(self, spec: PackedSpec, rebuild_every: int = 1,
                 pair_path: Optional[str] = None, mass: float = 1.0,
                 with_energy: bool = False,
                 nbr_table: Optional[tuple] = None,
                 always_repack: bool = False,
                 interpret: bool = False):
        """``with_energy=True`` makes EVERY force call accumulate
        energy/virial (default: inner MD steps skip them, refreshed at
        stride boundaries).  Required when the potential energy itself is
        a CV — the well-tempered-ensemble mode (EnergyCV / reference
        ``WellTemperedEnsemble``) reads state.potential_energy per step.

        ``nbr_table=(r_nb, K)`` maintains a (K, Npad) slot neighbor
        table (rebuilt at every repack, see ops/neighbor_table) that the
        sampler's order-CV hot path consumes instead of the masked roll
        sweep.  ``r_nb`` must bound every order-CV cutoff + skin (the
        sampler asserts) and fit the 27-cell stencil (asserted here).

        ``always_repack=True`` repacks UNconditionally at every rebuild
        boundary (a superset of the distance-triggered repacks — strictly
        safer, just slower).  Test hook: it makes repack TIMING
        deterministic, so trajectory-level oracles hold across engines
        whose repack triggers would otherwise couple differently (the
        walkers×space product mesh pmax-couples the decision across
        walkers — see SpatialPackedEngine.rebuild).

        ``pair_path`` ("triton" or "xla") overrides the platform's choice
        of pair force (``ops.packed_triton.choose_pair_path``);
        ``interpret=True`` runs the Triton kernel in the Pallas
        interpreter (CPU tests)."""
        self.spec = spec
        self.always_repack = always_repack
        self.nbr_table = nbr_table
        self.rebuild_every = rebuild_every
        self.pair_path = choose_pair_path(spec, pair_path)
        # live per-step energy/virial?  The kernel skips the sums on inner
        # steps unless with_energy; the XLA roll sweep always computes
        # them.  Consumers that read state.virial/.potential_energy
        # between stride boundaries (SCR-NPT, the WTE energy CV) check
        # this flag and fail loudly instead of integrating against zeros.
        self.virial_live = self.energy_live = bool(
            with_energy or self.pair_path == "xla")
        self._force = lambda st, sp: pair_force(
            st, sp, self.pair_path, with_energy=with_energy,
            interpret=interpret)
        self._force_e = lambda st, sp: pair_force(
            st, sp, self.pair_path, interpret=interpret)
        self.mass = mass

    # --- construction -----------------------------------------------------
    def pack_state(self, pos, box: Box, types, eps_i, sigma_i, vel=None,
                   image=None, extra_attrs=None):
        """Initial (sorted) pack from particle-order arrays, on the host
        (ops.packed.pack_host): one NumPy sort and one transfer, with no
        device compile.  The sort-free incremental repack handles all
        subsequent on-device migrations."""
        from ..ops.packed import pack_host
        state, overflow = pack_host(pos, box, self.spec, types, eps_i,
                                    sigma_i, vel=vel, image=image,
                                    extra_attrs=extra_attrs)
        return state, overflow

    # --- protocol ---------------------------------------------------------
    def init(self, state: PackedState):
        aux = PackedAux()
        if self.nbr_table is not None:
            from ..ops.neighbor_table import build_slot_neighbor_table
            r_nb, K = self.nbr_table
            assert state.box.tilt is None, (
                "the slot neighbor table uses orthorhombic minimum image; "
                "triclinic runs stay on the roll-sweep path")
            # stencil completeness: every pair within r_nb must be inside
            # the 27-cell neighborhood, i.e. r_nb <= min cell width.
            # (NPT compression shrinks the widths — size with headroom.)
            L = np.asarray(jax.device_get(state.box.L), np.float64)
            min_width = min(float(l) / c
                            for l, c in zip(L, self.spec.cells_per_dim))
            assert r_nb <= min_width + 1e-6, (
                f"nbr_table radius {r_nb} exceeds the stencil guarantee "
                f"(min cell width {min_width:.3f})")
            tbl, ovf = build_slot_neighbor_table(state, self.spec, r_nb, K)
            aux = PackedAux(overflow=ovf, nbr=tbl)
        return self.force_into(state, aux), aux

    def rebuild(self, state: PackedState, aux: PackedAux):
        need = (jnp.asarray(True) if self.always_repack
                else needs_repack(state, self.spec))

        if self.nbr_table is not None:
            from ..ops.neighbor_table import build_slot_neighbor_table
            r_nb, K = self.nbr_table

            def do_t(st):
                st2, bad = repack_incremental(st, self.spec)
                # slots moved — the table's indices are void; rebuild it
                # (radius r_nb >= cv cutoff + skin keeps it complete
                # until the next half-skin trigger)
                tbl, ovf = build_slot_neighbor_table(st2, self.spec,
                                                     r_nb, K)
                return st2, bad | ovf, tbl

            def dont_t(st):
                return st, st.pid[0] < 0, aux.nbr

            state, bad, tbl = jax.lax.cond(need, do_t, dont_t, state)
            return state, PackedAux(overflow=aux.overflow | bad,
                                    stale=aux.stale, nbr=tbl)

        def do(st):
            return repack_incremental(st, self.spec)

        def dont(st):
            # literal False would be REPLICATED under shard_map while the
            # do-branch flag is device-varying → cond type mismatch; derive
            # the constant from state so both branches vary alike
            return st, st.pid[0] < 0

        # forces travel with the slots in the repack columns, so no force
        # recomputation is needed after a migration
        state, bad = jax.lax.cond(need, do, dont, state)
        return state, PackedAux(overflow=aux.overflow | bad, stale=aux.stale)

    def force_into(self, state: PackedState, aux: PackedAux,
                   extra_force: Optional[jax.Array] = None) -> PackedState:
        state = self._force(state, self.spec)
        if extra_force is not None:
            state = state.replace(f=state.f + extra_force)
        return state

    def positions(self, state: PackedState) -> jax.Array:
        return state.r

    def with_positions(self, state: PackedState, r: jax.Array) -> PackedState:
        return state.replace(r=r)

    def refresh_energy(self, state: PackedState, aux) -> PackedState:
        """Recompute forces WITH energy/virial (stride-boundary metrics)."""
        return self._force_e(state, self.spec)

    def metrics(self, state: PackedState, aux: PackedAux) -> dict:
        # cell-width guard (VERDICT r3 item 8): the cell COUNT per axis is
        # compile-time static while the width L_d/c_d tracks the live box,
        # so sustained NPT compression can push a cell below r_cut+skin —
        # then the 27-cell stencil no longer covers r_list and pairs are
        # silently missed.  Surfaced per stride like nlist_overflow; the
        # CLI run-health guard refuses to exit 0 on it.
        cpd = jnp.asarray(np.asarray(self.spec.cells_per_dim, np.float32))
        if state.box.tilt is None:
            width = state.box.L / cpd
        else:
            from .box import h_matrix
            h = h_matrix(state.box)
            a, b, c = h[:, 0], h[:, 1], h[:, 2]
            vol = jnp.abs(jnp.dot(a, jnp.cross(b, c)))
            w_perp = jnp.stack([
                vol / jnp.linalg.norm(jnp.cross(b, c)),
                vol / jnp.linalg.norm(jnp.cross(c, a)),
                vol / jnp.linalg.norm(jnp.cross(a, b))])
            width = w_perp / cpd
        return {
            "temperature": packed_temperature(state, self.spec, self.mass),
            "potential_energy": state.potential_energy,
            "nlist_overflow": aux.overflow,
            "nlist_stale": aux.stale,
            "cell_width_violation": jnp.min(width) < self.spec.r_list,
        }
