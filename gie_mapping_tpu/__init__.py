"""GIE mapping engine: an incremental occupancy-grid + Euclidean distance
transform mapping engine in JAX/XLA, with the capabilities of the CUDA/ROS
reference engine GIE-mapping (RA-L 2022).  Runs on an NVIDIA GPU or the CPU
(ops/backend.py).

Layer map (top to bottom; see SURVEY.md §1 for the reference counterpart):
  models/    — sensor pipelines ("map makers") + the VolumetricMapper engine
  ops/       — dense JAX ops: sensors, raycast, batch EDT, fusion,
               block allocation, incremental-EDT relaxation, streaming
  parallel/  — device-mesh sharding of the mapping step (multi-device/host)
  runtime/   — host shell: datasets, CPU mirror map, native C++ helpers,
               logging, ground-truth checking
  utils/     — config, geometry, constants
"""

from .utils.config import (
    MapConfig,
    load_config,
    load_config_yaml,
    PRESETS,
)
from .utils import constants

__version__ = "0.1.0"


def create_mapper(case: str = "cow_lady", mesh=None, **overrides):
    """One-call engine construction for any benchmark case preset.

    mesh: optional jax.sharding.Mesh for multi-chip SPMD (parallel/mesh.py)."""
    from .models.mapper import VolumetricMapper

    return VolumetricMapper(load_config(case, **overrides), mesh=mesh)
