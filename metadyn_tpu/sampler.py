"""The metadynamics sampler — on-device ``IntegratorMetaDynamics``.

Reference parity: ``IntegratorMetaDynamics::update`` (recalled, SURVEY.md
§3.1).  The reference's per-step host path (CV eval → D2H scalar copy →
bias-factor set → GPU force kernels) becomes ONE jitted program: a
``lax.scan`` over MD steps inside a deposition stride (with neighbor-list
rebuild blocks nested inside), and the hill deposit as the fused tail of
each stride chunk (SURVEY.md §7 tenet 1) — no host round-trips, no
step-time spike at stride boundaries (BASELINE.md "hill-deposit latency").

Within a stride the bias grid is constant (as in the reference); every MD
step still re-interpolates ∂V/∂s at the current CV point and applies
F_bias = −∂V/∂s · ∂s/∂r through one vjp (cv/base.py).

Works over any engine implementing the core/engine.py protocol — the
particle-order engines and the packed production engine alike.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

from .core.state import State, System
from .core.engine import EngineAux
from .cv.base import CollectiveVariable
from .bias.grid import BiasGrid, GridSpec, value_and_grad
from .bias.hill_list import HillListBias, evaluate_on_grid
from .bias.metad import (
    BiasState, HillRecord, HillSpec, WallSpec, bias_value_and_grad, deposit,
    free_energy,
)
from .io.hill_log import HillLog
from .utils.profiling import phase


@struct.dataclass
class SamplerCarry:
    state: object
    bias: BiasState
    aux: object
    key: jax.Array
    step: jax.Array  # () i32 global step counter


class _CallableEngine:
    """Adapter: a plain apply-style ``force_apply(state) -> state`` as a
    rebuild-free engine (particle-order State only)."""

    rebuild_every: int = 10**9

    def __init__(self, fn: Callable, system: System):
        self.fn = fn
        self.system = system

    def init(self, state):
        return self.fn(state), EngineAux()

    def rebuild(self, state, aux):
        return state, aux

    def force_into(self, state, aux, extra_force=None):
        state = self.fn(state)
        if extra_force is not None:
            state = state.replace(force=state.force + extra_force)
        return state

    def positions(self, state):
        return state.pos

    def with_positions(self, state, r):
        return state.replace(pos=r)

    def refresh_energy(self, state, aux):
        return state

    def metrics(self, state, aux):
        from .core.state import temperature
        return {
            "temperature": temperature(state, self.system),
            "potential_energy": state.potential_energy,
            "nlist_overflow": jnp.asarray(False),
            "nlist_stale": jnp.asarray(False),
        }


def cv_stack(cvs, state, system):
    return jnp.stack([cv.value(state, system) for cv in cvs])


def make_bias_force_parts(engine, cvs, system: System,
                          walls: WallSpec | None = None):
    """Split the biased force into ``(eval_bias, apply_force)``:

      eval_bias(state, aux, bias) -> (g, dVds, s)  # the expensive CV sweeps
      apply_force(state, aux, g, dVds) -> state    # engine force + held g

    ``s`` (the CV values the sweep already computed) rides along so
    callers that need them per evaluation — the flux sampler's on-device
    visit/crossing histograms — don't pay a second CV traversal.

    :func:`make_biased_force` composes them per step; the multiple-time-
    stepping chunk (``bias_every`` > 1) calls ``eval_bias`` once per
    sub-chunk and holds ``g`` constant across the cheap inner steps."""
    # loud check (round-4 advisor): an energy CV on an engine whose inner
    # force path skips the energy accumulation (Pallas forces-only) would
    # silently bias against a frozen/zero potential_energy
    if any(getattr(cv, "needs_live_energy", False) for cv in cvs):
        assert getattr(engine, "energy_live", True), (
            "PotentialEnergyCV (WTE) reads state.potential_energy every "
            "bias evaluation, but this engine's inner force path skips "
            "the energy accumulation. Construct it with with_energy=True.")
    analytic = all(hasattr(cv, "accum_bias_force") for cv in cvs)
    # CVs with explicit box dependence supply a per-axis (3,) bias virial
    # (W = −dE_bias/dλ under uniform scaling) — e.g. the mesh CV's k-space
    # sum (SURVEY.md §3.3) and the MSD CV.  Scale-invariant CVs (lamellar:
    # k·r is a pure fractional coordinate; Steinhardt: bond directions)
    # contribute exactly zero and need no method.
    vir_cvs = [(i, cv) for i, cv in enumerate(cvs)
               if hasattr(cv, "bias_virial")]

    def add_bias_virial(state, dVds):
        if not vir_cvs:
            return state
        w = state.virial
        for i, cv in vir_cvs:
            w = w + cv.bias_virial(state, system, dVds[i])
        return state.replace(virial=w)

    # fused roll-sweep path: when EVERY CV implements the pair-sweep
    # protocol (packed order CVs), ALL values come from ONE (cap,cap,C)
    # traversal and ALL bias forces from ONE more, sharing the rolled
    # partner stacks — Config 3 ran 4-5 traversals per step before
    # (VERDICT r2 weak #2)
    fused = (len(cvs) > 0 and hasattr(engine, "spec")
             and all(hasattr(cv, "pair_value_terms") for cv in cvs))
    # neighbor-table path: the engine maintains a (K, Npad) slot
    # neighbor table (PackedEngine(nbr_table=...)); the per-step sweeps
    # then gather only real pairs instead of masking ~96% padding
    table = fused and getattr(engine, "nbr_table", None) is not None
    if table:
        r_nb, _K = engine.nbr_table
        for cv in cvs:
            rc = getattr(cv, "r_cut", None)
            assert rc is not None, (
                f"CV {cv.name}: the neighbor-table path needs an explicit "
                "r_cut (set PackedCoordination(r_cut=...))")
            assert rc + engine.spec.skin <= r_nb + 1e-6, (
                f"CV {cv.name}: r_cut {rc} + skin {engine.spec.skin} "
                f"exceeds the table radius {r_nb}")
        from .cv.packed_order import make_table_order_force
        tbl_values, tbl_force = make_table_order_force(
            list(cvs), engine.spec)
    if fused:
        from .cv.packed_order import make_fused_order_force
        fused_values, fused_force = make_fused_order_force(
            list(cvs), engine.spec)

    def grad_with_walls(bias, s):
        _, dVds = bias_value_and_grad(bias, s)
        if walls is not None:
            _, gw = walls.energy_and_grad(s)
            dVds = dVds + gw
        return dVds

    def eval_bias(state, aux, bias):
        if table:
            s, ctx = tbl_values(state, aux.nbr)
            dVds = grad_with_walls(bias, s)
            return tbl_force(state, aux.nbr, ctx, dVds), dVds, s
        if fused:
            s, ctx = fused_values(state)
            dVds = grad_with_walls(bias, s)
            return fused_force(state, ctx, dVds), dVds, s
        if analytic:
            s = cv_stack(cvs, state, system)
            dVds = grad_with_walls(bias, s)
            g = jnp.zeros_like(engine.positions(state))
            for i, cv in enumerate(cvs):
                g = cv.accum_bias_force(state, system, dVds[i], g)
            return g, dVds, s

        def stacked(r):
            return cv_stack(cvs, engine.with_positions(state, r), system)

        s, vjp = jax.vjp(stacked, engine.positions(state))
        dVds = grad_with_walls(bias, s)
        (g,) = vjp(dVds)
        return -g, dVds, s

    def apply_force(state, aux, g, dVds):
        return add_bias_virial(
            engine.force_into(state, aux, extra_force=g), dVds)

    return eval_bias, apply_force


def make_biased_force(engine, cvs, system: System, walls: WallSpec | None = None):
    """Engine force + metadynamics bias (+ optional CV wall).

    Default path: F_bias = −(∂V/∂s)·∂s/∂r through one vjp.  When every CV
    provides an analytic ``accum_bias_force`` (the packed hot-path CVs),
    the vjp is skipped entirely — one fused elementwise pass per CV,
    oracle-tested against the vjp path."""
    eval_bias, apply_force = make_bias_force_parts(engine, cvs, system, walls)

    def force(state, aux, bias):
        g, dVds, _ = eval_bias(state, aux, bias)
        return apply_force(state, aux, g, dVds)

    return force


def make_stride_chunk(
    engine,
    biased_force,
    cvs: Sequence[CollectiveVariable],
    system: System,
    hills: HillSpec,
    integrator_factory: Callable,
    bias_every: int = 1,
    bias_parts=None,
    add_hills: bool = True,
):
    """One deposition stride: nested scan of rebuild blocks × MD steps,
    then deposit a hill — all fused into the jitted outer scan body.

    ``integrator_factory`` is called with the biased force fn, or — if it
    accepts two arguments — with ``(force_fn, bias)`` so box-coupled
    integrators (NPT box-shape metadynamics, SURVEY.md §2a AspectRatio)
    can interpolate ∂V/∂s against the live bias inside the chunk.

    ``bias_every`` > 1 enables multiple-time-stepping for the BIAS force
    (the PLUMED ``MULTIPLE_TIME_STEP`` idea, Ferrarotti–Bottaro–Pérez-
    Villa–Bussi JCTC 11, 139 (2015)): the CV sweeps + ∂V/∂s evaluation run
    once per ``bias_every`` steps and the resulting bias force is HELD
    CONSTANT over the sub-chunk (constant-hold variant — same average
    impulse as PLUMED's ×k kick, smoother trajectories).  Valid when the
    bias force varies slowly over ``bias_every·dt`` — the usual case, as
    hills are deposited every ``stride`` ≫ ``bias_every`` steps.  The MD
    (pair/bond) force stays exact every step."""
    import inspect
    # count only parameters WITHOUT defaults: a one-arg factory carrying a
    # defaulted closure param (lambda f, _c=c: ...) must not get the bias
    # bound to its second slot (round-2 advisor, low)
    _params = inspect.signature(integrator_factory).parameters.values()
    want_bias = sum(
        1 for p in _params
        if p.default is inspect.Parameter.empty
        and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)) >= 2
    r = min(engine.rebuild_every, hills.stride)
    assert hills.stride % r == 0, (
        f"stride={hills.stride} must be a multiple of rebuild_every={r}")
    n_blocks = hills.stride // r
    if bias_every > 1:
        assert not want_bias, (
            "bias_every > 1 is not supported with box-coupled (two-arg) "
            "integrator factories — the box DOF needs the live bias")
        assert r % bias_every == 0, (
            f"bias_every={bias_every} must divide "
            f"min(rebuild_every, stride)={r}")
        assert bias_parts is not None
        eval_bias, apply_force = bias_parts

    def finish(carry, state, aux, bias):
        """Shared stride tail: energy refresh → deposit → metrics."""
        with phase("energy_refresh"):
            state = engine.refresh_energy(state, aux)
        new_step = carry.step + hills.stride
        with phase("cv_eval"):
            s = cv_stack(cvs, state, system)
        with phase("hill_deposit"):
            if add_hills:
                new_bias, rec = deposit(hills, bias, s, new_step)
            else:
                # frozen-bias run (reference ``add_hills=False``): the bias
                # still exerts forces but is never updated — production
                # sampling on a converged FES, e.g. after restart_from_grid
                new_bias = bias
                rec = HillRecord(step=new_step, center=s,
                                 height=jnp.float32(0.0))
        V, _ = bias_value_and_grad(new_bias, s)
        if isinstance(new_bias, BiasState):
            # CV outside the registered grid range → hills silently clamp;
            # surface it like the reference's grid-bounds warning
            oob = jnp.any((s < new_bias.grid.spec.lo)
                          | (s > new_bias.grid.spec.hi))
        else:
            # list mode has no bounds; surface buffer overflow instead
            oob = new_bias.overflowed
        metrics = {
            "step": new_step,
            "cv": s,
            "bias_V": V,
            "hill_height": rec.height,
            "cv_out_of_grid": oob,
            **engine.metrics(state, aux),
        }
        return (SamplerCarry(state, new_bias, aux, carry.key, new_step),
                (rec, metrics))

    def chunk(carry: SamplerCarry, _):
        bias = carry.bias

        def block(c, b):
            state, aux = c
            with phase("nlist_rebuild"):
                state, aux = engine.rebuild(state, aux)
            if bias_every > 1:
                def sub(st, j):
                    with phase("cv_eval"):
                        g, dVds, _ = eval_bias(st, aux, bias)
                    force_fn = lambda s2: apply_force(s2, aux, g, dVds)
                    step_fn = integrator_factory(force_fn)

                    def body(s2, i):
                        k = jax.random.fold_in(
                            carry.key,
                            carry.step + b * r + j * bias_every + i)
                        return step_fn(s2, k), None

                    st, _ = jax.lax.scan(body, st, jnp.arange(bias_every))
                    return st, None

                with phase("md_steps"):
                    state, _ = jax.lax.scan(
                        sub, state, jnp.arange(r // bias_every))
                return (state, aux), None
            force_fn = lambda st: biased_force(st, aux, bias)
            step_fn = (integrator_factory(force_fn, bias) if want_bias
                       else integrator_factory(force_fn))

            def body(st, i):
                k = jax.random.fold_in(carry.key, carry.step + b * r + i)
                return step_fn(st, k), None

            with phase("md_steps"):
                state, _ = jax.lax.scan(body, state, jnp.arange(r))
            return (state, aux), None

        (state, aux), _ = jax.lax.scan(
            block, (carry.state, carry.aux), jnp.arange(n_blocks))
        return finish(carry, state, aux, bias)

    return chunk


class MetadSampler:
    """User-facing driver mirroring ``metadynamics.integrate.mode_metadynamics``.

    Parameters mirror the reference python API (SURVEY.md §2a): hill height
    ``W``, ``stride``, ``deltaT``/mode via :class:`HillSpec`; per-CV grid
    ranges via :class:`GridSpec`; ``filename``/``overwrite`` via
    :class:`HillLog`.  ``engine`` is an engine-protocol object (AllPairs /
    Neighbor / Packed) or a plain apply-style ``force_apply(state)``.
    """

    def __init__(
        self,
        system: System,
        state,
        engine,
        cvs: Sequence[CollectiveVariable],
        grid_spec: Optional[GridSpec],
        hills: HillSpec,
        integrator_factory,
        seed: int = 0,
        hill_file: Optional[str] = None,
        overwrite: bool = False,
        initial_bias: Optional[BiasState] = None,
        chunks_per_block: int = 64,
        walls: Optional[WallSpec] = None,
        hill_sigma: Optional[Sequence[float]] = None,
        hill_capacity: int = 4096,
        spill_grid: Optional[GridSpec] = None,
        bias_every: int = 1,
        add_hills: bool = True,
    ):
        """``grid_spec=None`` selects the reference's non-grid hill-list
        mode (SURVEY.md §3.1): pass ``hill_sigma`` (per-CV widths), and
        optionally ``hill_capacity`` and a coarse ``spill_grid`` that
        absorbs hills past capacity so no bias is ever lost.

        ``bias_every`` > 1 holds the bias force constant for that many MD
        steps between CV re-evaluations (multiple-time-stepping — see
        :func:`make_stride_chunk`); the pair/bond forces stay exact.

        ``add_hills=False`` freezes the bias (the reference's
        ``mode_metadynamics(add_hills=False)``): forces from the current
        bias (usually seeded via ``initial_bias``) are applied but no
        hills are ever deposited and no hill file is written."""
        if grid_spec is not None:
            assert len(cvs) == grid_spec.ndim, "one grid dimension per CV"
        else:
            assert hill_sigma is not None and len(hill_sigma) == len(cvs), (
                "hill-list mode (grid_spec=None) needs hill_sigma per CV")
        if not hasattr(engine, "force_into"):
            engine = _CallableEngine(engine, system)
        self.engine = engine
        self.system = system
        self.cvs = list(cvs)
        self.hills = hills
        self.grid_spec = grid_spec
        self.walls = walls
        self._bias_parts = make_bias_force_parts(engine, cvs, system, walls)
        _eval, _apply = self._bias_parts
        self.biased_force = lambda st, aux, bias: _apply(
            st, aux, *_eval(st, aux, bias)[:2])
        if initial_bias is not None:
            bias = initial_bias
        elif grid_spec is not None:
            bias = BiasState.zeros(grid_spec)
        else:
            bias = HillListBias.create(hill_sigma, capacity=hill_capacity,
                                       spill_spec=spill_grid)

        # prime aux + forces at the initial positions (with any restart
        # bias) — inside ONE jit: eagerly this dispatches hundreds of tiny
        # ops (each a compile on a CPU device mesh), dominating
        # construction time.
        # Engines whose init() runs host-side shape asserts (nbr_table)
        # cannot trace — fall back to the eager path for those.
        def _prime(st, b):
            st2, aux2 = engine.init(st)
            return self.biased_force(st2, aux2, b), aux2

        try:
            state, aux = jax.jit(_prime)(state, bias)
        except (jax.errors.ConcretizationTypeError,
                jax.errors.TracerArrayConversionError):
            state, aux = engine.init(state)
            state = self.biased_force(state, aux, bias)

        self.carry = SamplerCarry(
            state=state, bias=bias, aux=aux,
            key=jax.random.PRNGKey(seed), step=jnp.int32(0),
        )
        chunk = make_stride_chunk(
            engine, self.biased_force, cvs, system, hills, integrator_factory,
            bias_every=bias_every, bias_parts=self._bias_parts,
            add_hills=add_hills)

        def run_chunks(carry, n):
            return jax.lax.scan(chunk, carry, None, length=n)

        # Fixed-size blocks: compile once for `chunks_per_block` strides and
        # loop blocks on the host (dispatch cost amortized over
        # stride·block steps).
        self._block = chunks_per_block
        self._run_chunks = jax.jit(run_chunks, static_argnums=1)
        self.hill_log = (HillLog(hill_file, self, overwrite=overwrite)
                         if hill_file and add_hills else None)
        self.history: list[dict] = []

    @property
    def state(self):
        return self.carry.state

    @property
    def bias(self) -> BiasState:
        return self.carry.bias

    def run(self, n_steps: int) -> list[dict]:
        """Run n_steps (must be a multiple of the deposition stride).

        Returns per-stride metric dicts (host numpy), appends the hill log.
        """
        stride = self.hills.stride
        assert n_steps % stride == 0, "n_steps must be a multiple of stride"
        n_chunks = n_steps // stride
        out = []
        remaining = n_chunks
        while remaining > 0:
            n = self._block if remaining >= self._block else remaining
            self.carry, (recs, metrics) = self._run_chunks(self.carry, n)
            recs, metrics = jax.device_get((recs, metrics))
            for i in range(n):
                out.append({k: np.asarray(v[i]) for k, v in metrics.items()})
            if self.hill_log is not None:
                self.hill_log.append(recs)
            remaining -= n
        self.history.extend(out)
        return out

    def free_energy(self, kT: float,
                    eval_spec: Optional[GridSpec] = None) -> np.ndarray:
        """FES estimate on the bias grid (see bias.metad.free_energy).

        Hill-list mode has no native grid: pass ``eval_spec`` to choose the
        reconstruction points (hills are summed analytically onto it)."""
        bias = self.carry.bias
        if isinstance(bias, HillListBias):
            assert eval_spec is not None, (
                "hill-list mode: pass eval_spec for FES reconstruction")
            V = evaluate_on_grid(bias, eval_spec)
            bias = BiasState(
                grid=BiasGrid(spec=eval_spec, V=V,
                              dV=jnp.zeros((eval_spec.ndim,
                                            *eval_spec.shape))),
                n_hills=bias.n_hills)
        return np.asarray(free_energy(self.hills, bias, jnp.float32(kT)))

    def grid_coords(self, d: int = 0) -> np.ndarray:
        return np.asarray(self.grid_spec.axis_coords(d))
