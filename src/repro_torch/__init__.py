"""PyTorch/CUDA port of the differentiable CT projector library.

The layout mirrors the JAX reference package module for module
(``repro_torch/core/geometry.py`` <-> ``repro/core/geometry.py``, ...).  The
parallel-beam Separable-Footprint forward/back projection pair runs on
hand-written CUDA kernels (``kernels/csrc``) for CUDA tensors and on its
plain PyTorch version for CPU tensors.

Importing this package loads neither the compiled kernel library nor any
GPU toolchain: kernels are built with ``nvcc`` on first use.
"""
from repro_torch.core.geometry import (CTGeometry, VolumeGeometry, cone_beam,
                                       fan_beam, from_config, helical_beam,
                                       modular_beam, parallel_beam)
from repro_torch.core.spec import ProjectorSpec, ShardSpec
from repro_torch.core.projector import Projector
from repro_torch.kernels.ops import back_project, forward_project, resolve_mode

__all__ = [
    "CTGeometry", "VolumeGeometry", "parallel_beam", "fan_beam", "cone_beam",
    "modular_beam", "helical_beam", "from_config", "ProjectorSpec", "ShardSpec",
    "Projector", "forward_project", "back_project", "resolve_mode",
]
