"""Device rules of the port.

Entry points run on the card unless the caller asks for the CPU: a
``device=None`` argument resolves to ``cuda`` and raises when CUDA is
absent, naming ``device="cpu"`` as the way to run on the host.  The ops
themselves follow their input tensor's device (see ``kernels/ops.py``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "cuda_required_error", "requires_cuda"]


def cuda_required_error(what: str = "this entry point") -> RuntimeError:
    return RuntimeError(
        f"{what} runs on a CUDA device by default, but "
        f"torch.cuda.is_available() is False; pass device=\"cpu\" to run "
        f"on the CPU instead")


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   what: str = "this entry point") -> torch.device:
    """``None`` -> ``cuda`` (raising when CUDA is absent); anything else is
    taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise cuda_required_error(what)
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise cuda_required_error(what)
    return dev


def requires_cuda() -> None:
    """Skip the calling test when no CUDA device is present.  Call it inside
    the test body: deciding at import time would let test workers collect
    different tests."""
    import pytest
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
