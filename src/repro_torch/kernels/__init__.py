"""CUDA kernels + plain PyTorch references for the differentiable projectors.

Importing this package registers every ported kernel pair with the dispatch
table in ``repro_torch.kernels.ops``.  It neither builds nor loads the
compiled libraries: ``kernels/build.py`` does that on the first launch.

:func:`launches` merges the launch counts of every kernel module;
:func:`reset_launches` sets them all to 0.
"""
from typing import Dict

from repro_torch.kernels import (fp_cone, fp_fan, fp_modular, fp_par,  # noqa: F401
                                 ops, ref, tune)
from repro_torch.kernels.tune import KernelConfig  # noqa: F401

_MODULES = (fp_par, fp_fan, fp_cone, fp_modular)

for _m in _MODULES:
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
