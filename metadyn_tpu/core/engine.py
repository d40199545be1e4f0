"""Force engines: force evaluation + auxiliary structures (neighbor lists).

The reference separates ``ForceCompute`` (per-step) from ``NeighborList``
(rebuilt on demand via a distance check, SURVEY.md §2b).  On device a
data-dependent rebuild inside ``lax.scan`` would force a host sync or a
both-branches ``cond``, so engines rebuild on a **fixed cadence**
(``rebuild_every`` steps, SURVEY.md §7 hard part 1): the skin is sized so
half-skin violations within a block are rare, and an actual violation is
surfaced as a staleness metric rather than silently corrupting forces.

Engine protocol (uniform across the particle-order engines here and the
packed hot-path engine in packed_engine.py):

- ``init(state) -> (state, aux)``       — build aux, compute initial forces
- ``rebuild(state, aux) -> (state, aux)`` — refresh neighbor structures
  (the packed engine migrates slots, hence state may change)
- ``force_into(state, aux, extra_force=None) -> state`` — evaluate forces
  (+ an optional additive external/bias force) and store force, potential
  energy and virial in the state
- ``positions(state)`` / ``with_positions(state, r)`` — the differentiable
  position leaf (used by the CV vjp chain rule)
- ``metrics(state) -> dict`` — temperature, potential energy, …
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from .state import State, System, temperature
from .box import Box
from ..ops.pairs import PairKernel, PairParams, PairForceResult, all_pairs_force
from ..ops import bonds as bond_ops
from ..ops.cell_list import (
    CellSpec, NeighborList, build_neighbor_list, needs_rebuild,
)
from ..ops.neighbor_force import neighbor_pair_force


@struct.dataclass
class EngineAux:
    """Auxiliary carry for a force engine (empty for all-pairs)."""

    nbr: Optional[NeighborList] = None
    # sticky flags accumulated across rebuilds within a run segment
    overflow: jax.Array = struct.field(default_factory=lambda: jnp.asarray(False))
    stale: jax.Array = struct.field(default_factory=lambda: jnp.asarray(False))


class ForceEngine:
    """Base for particle-order engines: bond/external composition + protocol."""

    rebuild_every: int = 10**9  # all-pairs: never

    def __init__(self, system: System, harmonic=None, fene=None, external=None):
        self.system = system
        self.harmonic = harmonic
        self.fene = fene
        self.external = external

    # --- protocol ---------------------------------------------------------
    def init(self, state: State):
        aux = self._make_aux(state)
        return self.force_into(state, aux), aux

    def rebuild(self, state: State, aux: EngineAux):
        return state, aux

    def force_into(self, state: State, aux: EngineAux,
                   extra_force: Optional[jax.Array] = None) -> State:
        res = self._net_force(state, aux)
        f = res.force if extra_force is None else res.force + extra_force
        return state.replace(force=f, potential_energy=res.energy,
                             virial=res.virial)

    def positions(self, state: State) -> jax.Array:
        return state.pos

    def with_positions(self, state: State, r: jax.Array) -> State:
        return state.replace(pos=r)

    def refresh_energy(self, state: State, aux) -> State:
        return state  # particle-order engines always carry fresh energy

    def metrics(self, state: State, aux: EngineAux) -> dict:
        return {
            "temperature": temperature(state, self.system),
            "potential_energy": state.potential_energy,
            "nlist_overflow": aux.overflow,
            "nlist_stale": aux.stale,
        }

    # --- internals --------------------------------------------------------
    def _make_aux(self, state: State) -> EngineAux:
        return EngineAux()

    def _common(self, state: State) -> PairForceResult:
        e = jnp.float32(0.0)
        f = jnp.zeros_like(state.pos)
        # derive from state so the value stays device-varying under
        # shard_map (a literal 0.0 is unvarying and breaks scan carries)
        w = state.virial * 0.0
        if self.harmonic is not None:
            r = bond_ops.harmonic_bond_force(
                state.pos, self.system.bonds, self.system.bond_types,
                state.box, self.harmonic)
            e, f, w = e + r.energy, f + r.force, w + r.virial
        if self.fene is not None:
            r = bond_ops.fene_bond_force(
                state.pos, self.system.bonds, self.system.bond_types,
                state.box, self.fene)
            e, f, w = e + r.energy, f + r.force, w + r.virial
        if self.external is not None:
            e_ext, g = jax.value_and_grad(self.external)(
                state.pos, state, self.system)
            e, f = e + e_ext, f - g
        return PairForceResult(e, f, w)

    def _net_force(self, state: State, aux: EngineAux) -> PairForceResult:
        return self._common(state)


class AllPairsEngine(ForceEngine):
    """O(N²) masked reference engine (small systems, oracle for the list)."""

    def __init__(self, system: System, pair_params: Optional[PairParams] = None,
                 pair_kernel: Optional[PairKernel] = None, row_block: int = 1024,
                 harmonic=None, fene=None, external=None):
        super().__init__(system, harmonic, fene, external)
        self.pair_params = pair_params
        self.pair_kernel = pair_kernel
        self.row_block = row_block

    def _net_force(self, state: State, aux: EngineAux) -> PairForceResult:
        res = self._common(state)
        if self.pair_params is not None:
            r = all_pairs_force(state.pos, self.system.types, state.box,
                                self.pair_kernel, self.pair_params, self.row_block)
            res = PairForceResult(res.energy + r.energy, res.force + r.force,
                                  res.virial + r.virial)
        return res


class NeighborEngine(ForceEngine):
    """Particle-order cell-list engine (gather-based; CPU/medium systems —
    the production engine is packed_engine.PackedEngine)."""

    def __init__(self, system: System, cell_spec: CellSpec,
                 pair_params: PairParams, pair_kernel: PairKernel,
                 rebuild_every: int = 10,
                 exclusions: Optional[jax.Array] = None,
                 harmonic=None, fene=None, external=None):
        super().__init__(system, harmonic, fene, external)
        self.cell_spec = cell_spec
        self.pair_params = pair_params
        self.pair_kernel = pair_kernel
        self.rebuild_every = rebuild_every
        self.exclusions = exclusions

    def _make_aux(self, state: State) -> EngineAux:
        nbr = build_neighbor_list(state.pos, state.box, self.cell_spec,
                                  self.exclusions)
        return EngineAux(nbr=nbr, overflow=nbr.overflow,
                         stale=jnp.asarray(False))

    def rebuild(self, state: State, aux: EngineAux):
        # record a half-skin violation BEFORE rebuilding: it means some steps
        # in the previous block ran with a stale list
        stale = aux.stale | needs_rebuild(aux.nbr, state.pos, state.box)
        nbr = build_neighbor_list(state.pos, state.box, self.cell_spec,
                                  self.exclusions)
        return state, EngineAux(nbr=nbr, overflow=aux.overflow | nbr.overflow,
                                stale=stale)

    def _net_force(self, state: State, aux: EngineAux) -> PairForceResult:
        res = self._common(state)
        r = neighbor_pair_force(state.pos, self.system.types, state.box,
                                aux.nbr, self.pair_kernel, self.pair_params)
        return PairForceResult(res.energy + r.energy, res.force + r.force,
                               res.virial + r.virial)


def run_md_blocks(
    engine,
    step_factory: Callable,
    state,
    aux,
    key: jax.Array,
    n_steps: int,
    start_step: jax.Array | int = 0,
):
    """Run n_steps with periodic rebuilds, fully on device.

    Structure: scan over blocks of ``rebuild_every`` steps, rebuilding at
    each block head (static shapes, no host sync; SURVEY.md §7 tenet 1).
    """
    r = min(engine.rebuild_every, n_steps)
    n_blocks, rem = divmod(n_steps, r)
    assert rem == 0, f"n_steps={n_steps} must be a multiple of rebuild_every={r}"
    start_step = jnp.asarray(start_step, jnp.int32)

    def block(carry, b):
        state, aux = carry
        state, aux = engine.rebuild(state, aux)
        step = step_factory(lambda st: engine.force_into(st, aux))

        def body(st, i):
            return step(st, jax.random.fold_in(key, start_step + b * r + i)), None

        state, _ = jax.lax.scan(body, state, jnp.arange(r))
        return (state, aux), None

    (state, aux), _ = jax.lax.scan(block, (state, aux), jnp.arange(n_blocks))
    return state, aux
