"""metadyn_tpu — on-device enhanced-sampling molecular dynamics in JAX.

A from-scratch JAX/Pallas re-design of the capabilities of
jglaser/metadynamics-plugin (HOOMD-blue metadynamics) as a standalone
engine.  See README.md and SURVEY.md.
"""

from .core.box import Box
from .core.state import (
    State, System, make_state, make_system, thermal_velocities,
    kinetic_energy, temperature, pressure,
)
from .core.forcefield import ForceField
from .core.engine import AllPairsEngine, NeighborEngine
from .core.packed_engine import PackedEngine
from .bias.grid import GridSpec, BiasGrid
from .bias.hill_list import HillListBias
from .bias.metad import (
    HillSpec, BiasState, WallSpec, STANDARD, WELL_TEMPERED, FLUX_TEMPERED,
    free_energy,
)
from .sampler import MetadSampler
from .flux_sampler import FluxTemperedSampler
from .parallel.walkers import WalkerSampler

__version__ = "0.1.0"

__all__ = [
    "Box", "State", "System", "make_state", "make_system",
    "thermal_velocities", "kinetic_energy", "temperature", "pressure",
    "ForceField", "AllPairsEngine", "NeighborEngine", "PackedEngine",
    "GridSpec", "BiasGrid", "HillListBias", "HillSpec", "BiasState", "WallSpec",
    "STANDARD", "WELL_TEMPERED", "FLUX_TEMPERED", "free_energy",
    "MetadSampler", "FluxTemperedSampler", "WalkerSampler",
]
