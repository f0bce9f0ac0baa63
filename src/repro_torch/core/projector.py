"""The ``Projector`` module — the library's main user-facing class.

    >>> spec = ProjectorSpec(geom)             # frozen op description
    >>> proj = Projector(spec)                 # on "cuda"; device="cpu" asks
    ...                                        # for the host
    >>> sino = proj(volume)                    # A x        (differentiable)
    >>> vol  = proj.backproject(sino)          # A^T y      (differentiable)
    >>> rec  = proj.fbp(sino)                  # filtered backprojection
    >>> loss = proj.data_consistency(volume, measured)   # ||Ax - y||^2 term

Batched inputs (leading dims) are supported; gradients flow through every
method via the matched autograd pair in ``repro_torch.kernels.ops``.  On a
CUDA device the forward and back projections run the hand-written kernels,
so every gradient is the exact transpose of the forward kernel.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.fbp import fbp as _fbp
from repro_torch.core.geometry import CTGeometry
from repro_torch.core.spec import ProjectorSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.tune import KernelConfig


class Projector:
    def __init__(self, spec: ProjectorSpec,
                 device: Optional[Union[str, torch.device]] = None):
        """``device=None`` means ``cuda`` and raises when CUDA is absent;
        pass ``device="cpu"`` to run on the host.  Inputs must live on the
        projector's device type."""
        if not isinstance(spec, ProjectorSpec):
            raise TypeError(f"Projector needs a ProjectorSpec, got "
                            f"{type(spec).__name__}")
        self.spec = spec
        self.device = resolve_device(device, "Projector")

    @property
    def geom(self) -> CTGeometry:
        return self.spec.geom

    @property
    def model(self) -> str:
        return self.spec.model

    @property
    def backend(self) -> str:
        return self.spec.backend

    @property
    def config(self) -> Optional[KernelConfig]:
        return self.spec.config

    @property
    def mode(self) -> str:
        return self.spec.mode

    @property
    def compute_dtype(self):
        return self.spec.compute_dtype

    @classmethod
    def from_model_config(cls, geom: CTGeometry, model_config,
                          device: Optional[Union[str, torch.device]] = None,
                          **kwargs) -> "Projector":
        """A projector honoring a ``models.config.ModelConfig``: its
        ``compute_dtype`` becomes the kernel tile precision, so a
        reconstruction head shares one precision policy with the model
        around it.  ``kwargs`` are further ``ProjectorSpec`` fields."""
        kwargs.setdefault("compute_dtype",
                          getattr(model_config, "compute_dtype", None))
        return cls(ProjectorSpec(geom, **kwargs), device)

    def _on_device(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != self.device.type:
            raise ValueError(
                f"this Projector runs on {self.device}, but got a tensor on "
                f"{x.device}; move it with .to({str(self.device)!r})")
        return x

    # -- linear ops -------------------------------------------------------- #
    def __call__(self, volume: torch.Tensor) -> torch.Tensor:
        return ops.forward_project(self._on_device(volume), self.spec)

    forward = __call__

    def backproject(self, sino: torch.Tensor) -> torch.Tensor:
        return ops.back_project(self._on_device(sino), self.spec)

    @property
    def T(self):
        return self.backproject

    # -- analytic reconstruction ------------------------------------------ #
    def fbp(self, sino: torch.Tensor, filter_name: str = "ramp",
            short_scan: Optional[bool] = None) -> torch.Tensor:
        """``short_scan`` applies Parker weighting for fan beams (``None``
        auto-detects from the geometry's angular span)."""
        return _fbp(self._on_device(sino), self.geom, filter_name=filter_name,
                    short_scan=short_scan)

    # -- DL integration ---------------------------------------------------- #
    def data_consistency(self, volume, measured, mask=None) -> torch.Tensor:
        """0.5 * || M (A x - y) ||^2 / n  — the paper's data-consistency loss.

        ``mask`` selects measured views/pixels (limited-angle / few-view)."""
        r = self(volume) - measured
        if mask is not None:
            r = r * mask
        return 0.5 * torch.mean(torch.square(r))

    def complete_sinogram(self, volume, measured, mask) -> torch.Tensor:
        """Sinogram completion (paper §3): keep measured views, fill the rest
        from the forward projection of the predicted volume."""
        synth = self(volume)
        return mask * measured + (1.0 - mask) * synth

    # -- misc --------------------------------------------------------------- #
    def sino_shape(self):
        return self.geom.sino_shape

    def vol_shape(self):
        return self.geom.vol.shape

    # The solvers' view of the operator, shared with
    # ``core.distributed.DistributedProjector``: the shapes of the pieces this
    # process holds, and the sum of partial sums over every process's pieces.
    # On one device the pieces are the whole tensors and the sum is the
    # partial itself.
    local_sino_shape = sino_shape
    local_vol_shape = vol_shape

    def reduce_partial(self, t: torch.Tensor, space: str) -> torch.Tensor:
        """``t`` unchanged: one device holds every term of a sum over the
        sinogram (``space="sino"``) or the volume (``"vol"``)."""
        return t

    def __repr__(self):
        g = self.geom
        mode = f", mode={self.mode}" if self.mode != "auto" else ""
        cdt = (f", compute_dtype={self.compute_dtype}"
               if self.compute_dtype is not None else "")
        return (f"Projector({g.geom_type}, model={self.model}{mode}{cdt}, "
                f"device={self.device}, vol={g.vol.shape}, "
                f"sino={g.sino_shape})")
