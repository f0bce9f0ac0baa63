"""The port's matched autograd pair, op cache and device rules."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import Projector, ProjectorSpec, VolumeGeometry, parallel_beam
from repro_torch.kernels import ops


def _proj(**kw):
    g = parallel_beam(8, 4, 30, VolumeGeometry(20, 20, 4))
    return Projector(ProjectorSpec(g, **kw), device="cpu")


def _xy(proj, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=batch + proj.vol_shape()).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=batch + proj.sino_shape()).astype(np.float32))
    return x, y


@pytest.mark.parametrize("batch", [(), (2, 3)])
def test_dot_test(batch):
    proj = _proj()
    x, y = _xy(proj, batch=batch)
    lhs = float((proj(x).double() * y.double()).sum())
    rhs = float((x.double() * proj.T(y).double()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-4


def test_gradient_is_backprojection():
    proj = _proj()
    x, y = _xy(proj, 1)
    x.requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(x) - y) ** 2), x)
    expected = proj.T(proj(x.detach()) - y)
    np.testing.assert_allclose(grad.numpy(), expected.numpy(), rtol=1e-4, atol=1e-5)


def test_double_differentiation():
    """grad of <A^T y, x> with respect to y is A x."""
    proj = _proj()
    x, y = _xy(proj, 2)
    y.requires_grad_()
    (grad_y,) = torch.autograd.grad(torch.sum(proj.T(y) * x), y)
    np.testing.assert_allclose(grad_y.numpy(), proj(x).numpy(), rtol=1e-4, atol=1e-5)


def test_hessian_vector_product():
    """Second order through the pair: H v of 0.5||Ax - y||^2 is A^T(A v)."""
    proj = _proj()
    x, y = _xy(proj, 3)
    v, _ = _xy(proj, 4)
    x.requires_grad_()
    (g,) = torch.autograd.grad(0.5 * torch.sum((proj(x) - y) ** 2), x,
                               create_graph=True)
    (hv,) = torch.autograd.grad(torch.sum(g * v), x)
    np.testing.assert_allclose(hv.numpy(), proj.T(proj(v)).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_equal_specs_share_cache_entry():
    g1 = parallel_beam(6, 2, 24, VolumeGeometry(16, 16, 2))
    g2 = repro_torch.from_config(g1.to_config())
    x = torch.ones(g1.vol.shape)
    ops.forward_project(x, ProjectorSpec(g1))
    before = ops.cache_stats()
    ops.forward_project(x, ProjectorSpec(g2))
    after = ops.cache_stats()
    assert after["size"] == before["size"]
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]
    assert ops.get_ops(ProjectorSpec(g1), x) is ops.get_ops(ProjectorSpec(g2), x)


def test_projector_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = parallel_beam(6, 2, 24, VolumeGeometry(16, 16, 2))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Projector(ProjectorSpec(g))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Projector(ProjectorSpec(g), device="cuda")


def test_cuda_backend_on_cpu_tensor_raises():
    proj = _proj(backend="cuda")
    x, y = _xy(proj)
    with pytest.raises(ValueError, match="CUDA tensor"):
        proj(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        proj.T(y)


def test_unported_geometry_raises_not_implemented():
    vol = VolumeGeometry(8, 8, 4)
    g = repro_torch.cone_beam(4, 4, 8, vol, sod=40.0, sdd=80.0,
                              detector_type="curved")
    # no SF pair on a curved cone detector, as in the reference
    with pytest.raises(NotImplementedError, match="flat detectors"):
        Projector(ProjectorSpec(g), device="cpu")(torch.zeros(vol.shape))


def test_data_consistency_and_completion():
    proj = _proj()
    x, y = _xy(proj, 5)
    r = proj(x) - y
    assert torch.allclose(proj.data_consistency(x, y), 0.5 * torch.mean(r ** 2))
    mask = torch.zeros(proj.sino_shape())
    mask[::2] = 1.0
    done = proj.complete_sinogram(x, y, mask)
    assert torch.equal(done[::2], y[::2])
    assert torch.allclose(done[1::2], proj(x)[1::2])
