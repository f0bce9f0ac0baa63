"""The CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; they skip elsewhere.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import Projector, ProjectorSpec, VolumeGeometry, parallel_beam
from repro_torch.device import requires_cuda
from repro_torch.kernels import fp_par, precision, tune
from repro_torch.kernels.fp_par import ParallelPlan

pytestmark = pytest.mark.cuda

SHAPES = [
    (16, 16, 4, 6, 4, 24, 1),      # nx, ny, nz, na, nv, nu, batch
    (24, 24, 2, 5, 2, 40, 3),      # ragged lanes (6) and columns
    (64, 64, 1, 90, 1, 96, 8),     # the 2D training shape, cut down
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(shape, dtype):
    requires_cuda()
    nx, ny, nz, na, nv, nu, batch = shape
    g = parallel_beam(na, nv, nu, VolumeGeometry(nx, ny, nz))
    plan = ParallelPlan(g)
    cfg = tune.heuristic_config(g, batch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    vol = torch.randn((nx, ny, batch * nv), generator=gen, device="cuda").to(dt)
    sino = torch.randn((na, nu, batch * nv), generator=gen, device="cuda").to(dt)
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    fp_par.reset_launches()
    for run, plain, x in ((fp_par.fp_lanes, fp_par.fp_lanes_plain, vol),
                          (fp_par.bp_lanes, fp_par.bp_lanes_plain, sino)):
        got = run(x, plan, cfg)
        torch.cuda.synchronize()
        want = plain(x, plan)
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel
    assert fp_par.LAUNCHES["fp_par_sf"] >= 1 and fp_par.LAUNCHES["bp_par_sf"] >= 1


def test_kernel_pair_dot_test_and_gradient():
    requires_cuda()
    g = parallel_beam(10, 6, 36, VolumeGeometry(24, 24, 6))
    proj = Projector(ProjectorSpec(g, backend="cuda"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=g.vol.shape).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=g.sino_shape).astype(np.float32)).cuda()
    lhs = float((proj(x).double() * y.double()).sum())
    rhs = float((x.double() * proj.T(y).double()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - y) ** 2), xg)
    torch.testing.assert_close(grad, proj.T(proj(x) - y), rtol=1e-4, atol=1e-5)
