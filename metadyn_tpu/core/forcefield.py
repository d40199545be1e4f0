"""Force-field composition — the JAX equivalent of HOOMD's net-force pass.

Reference parity: ``IntegratorTwoStep::computeNetForce`` iterating over
registered ``ForceCompute`` objects (SURVEY.md §3.1).  Here a force field is
a pure function ``(state) -> ForceResult`` composed from pair / bond terms;
the metadynamics bias force is added by the sampler on top (cv chain rule).
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from ..utils import struct

from .state import State, System
from ..ops.pairs import PairKernel, PairParams, PairForceResult, all_pairs_force
from ..ops import bonds as bond_ops

ForceFn = Callable[[State], PairForceResult]


@struct.dataclass
class ForceField:
    """Declarative force-field spec; ``bind`` closes it over a System."""

    pair_params: Optional[PairParams] = None
    pair_kernel: Optional[PairKernel] = struct.field(pytree_node=False, default=None)
    harmonic: Optional[bond_ops.HarmonicBondParams] = None
    fene: Optional[bond_ops.FENEBondParams] = None
    # external(pos, state, system) -> scalar energy; force via autodiff.
    # Covers HOOMD's external.periodic-style fields and test toy potentials.
    external: Optional[Callable] = struct.field(pytree_node=False, default=None)
    row_block: int = struct.field(pytree_node=False, default=1024)

    def bind(self, system: System) -> Callable[[State], State]:
        """Apply-style closure: evaluates all terms and writes force/energy
        into the state (the integrator-facing convention)."""
        raw = self.bind_raw(system)

        def force_apply(state: State) -> State:
            res = raw(state)
            return state.replace(force=res.force, potential_energy=res.energy,
                                 virial=res.virial)

        return force_apply

    def bind_raw(self, system: System) -> ForceFn:
        def force_fn(state: State) -> PairForceResult:
            e = jnp.float32(0.0)
            f = jnp.zeros_like(state.pos)
            # derive from state so the value stays device-varying under
            # shard_map (a literal 0.0 is unvarying and breaks scan carries)
            w = state.virial * 0.0
            if self.pair_params is not None:
                r = all_pairs_force(
                    state.pos, system.types, state.box,
                    self.pair_kernel, self.pair_params, self.row_block,
                )
                e, f, w = e + r.energy, f + r.force, w + r.virial
            if self.harmonic is not None:
                r = bond_ops.harmonic_bond_force(
                    state.pos, system.bonds, system.bond_types, state.box, self.harmonic)
                e, f, w = e + r.energy, f + r.force, w + r.virial
            if self.fene is not None:
                r = bond_ops.fene_bond_force(
                    state.pos, system.bonds, system.bond_types, state.box, self.fene)
                e, f, w = e + r.energy, f + r.force, w + r.virial
            if self.external is not None:
                e_ext, g = jax.value_and_grad(self.external)(state.pos, state, system)
                e, f = e + e_ext, f - g
            return PairForceResult(e, f, w)

        return force_fn
