"""CUDA kernels + plain PyTorch references for the differentiable projectors
and for the language model's flash attention (``flash``).

Importing this package registers every ported projector pair with the
dispatch table in ``repro_torch.kernels.ops``.  It neither builds nor loads the
compiled libraries: ``kernels/build.py`` does that on the first launch.

:func:`launches` merges the launch counts of every kernel module;
:func:`reset_launches` sets them all to 0.
"""
from typing import Dict

from repro_torch.kernels import (flash, fp_cone, fp_fan, fp_modular,  # noqa: F401
                                 fp_par, ops, ref, tune)
from repro_torch.kernels.tune import KernelConfig  # noqa: F401

_PAIRS = (fp_par, fp_fan, fp_cone, fp_modular)
_MODULES = _PAIRS + (flash,)

for _m in _PAIRS:
    _m.register()


def launches() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`, by kernel."""
    out: Dict[str, int] = {}
    for m in _MODULES:
        out.update(m.LAUNCHES)
    return out


def reset_launches() -> None:
    for m in _MODULES:
        m.reset_launches()
