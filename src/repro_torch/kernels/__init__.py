"""CUDA kernels + plain PyTorch references for the differentiable projectors.

Importing this package registers every ported kernel pair with the dispatch
table in ``repro_torch.kernels.ops``.  It neither builds nor loads the
compiled library: ``kernels/build.py`` does that on the first launch.
"""
from repro_torch.kernels import fp_par, ops, ref, tune  # noqa: F401
from repro_torch.kernels.tune import KernelConfig  # noqa: F401

fp_par.register()
