"""The port's exact flat-detector cone SF pair (the CPU path of the kernel
wrappers, and the ``ref`` backend) against the reference package: its
per-view tables, its plain oracle ``ref.forward``/``ref.adjoint`` and its
Pallas kernels in interpret mode, at the cone tolerance 3e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
from repro.kernels import fp_cone as jfp_cone
from repro.kernels import ref as jref

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec
from repro_torch.kernels import fp_cone, precision
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fp_cone import ConePlan

TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# tests/test_kernels.py:111-116: nx, ny, nz, na, nv, nu, sod, sdd
CONE_SHAPES = [
    (16, 16, 8, 6, 8, 24, 80.0, 160.0),
    (24, 24, 4, 5, 8, 36, 120.0, 200.0),
    (16, 16, 16, 4, 16, 24, 60.0, 150.0),
]


def _pair(shape, **vk):
    nx, ny, nz, na, nv, nu, sod, sdd = shape
    kw = dict(sod=sod, sdd=sdd, pixel_width=2.0, pixel_height=2.0)
    return (jgeo.cone_beam(na, nv, nu, jgeo.VolumeGeometry(nx, ny, nz, **vk), **kw),
            tgeo.cone_beam(na, nv, nu, tgeo.VolumeGeometry(nx, ny, nz, **vk), **kw))


def _data(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_view_params_cone_bit_identical():
    vk = dict(dx=1.5, dy=1.5, dz=2.0, offset_x=1.3, offset_y=-0.7, offset_z=0.5)
    jg, tg = _pair((20, 20, 6, 17, 8, 30, 90.0, 170.0), **vk)
    for a, b in zip(fp_cone._view_params_cone(tg), jfp_cone._view_params_cone(jg)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    plan = ConePlan(tg)
    assert plan.taps_u == jg.max_footprint_cols()
    assert plan.taps_v == jg.max_footprint_rows()


@pytest.mark.parametrize("shape", CONE_SHAPES)
def test_fp_bp_match_reference_oracle(shape):
    jg, tg = _pair(shape)
    plan = ConePlan(tg)
    f, y = _data(tg.vol.shape, 0), _data(tg.sino_shape, 1)
    p_ref = np.asarray(jref.forward(jnp.asarray(f), jg))
    b_ref = np.asarray(jref.adjoint(jnp.asarray(y), jg))
    np.testing.assert_allclose(
        fp_cone.fp_cone_sf(torch.from_numpy(f), plan).numpy(), p_ref, **TOL)
    np.testing.assert_allclose(
        fp_cone.bp_cone_sf(torch.from_numpy(y), plan).numpy(), b_ref, **TOL)
    np.testing.assert_allclose(
        tref.forward(torch.from_numpy(f), tg).numpy(), p_ref, **TOL)
    np.testing.assert_allclose(
        tref.adjoint(torch.from_numpy(y), tg).numpy(), b_ref, **TOL)


def test_fp_bp_match_pallas_interpret():
    jg, tg = _pair(CONE_SHAPES[0])
    plan = ConePlan(tg)
    f, y = _data(tg.vol.shape, 2), _data(tg.sino_shape, 3)
    np.testing.assert_allclose(
        fp_cone.fp_cone_sf(torch.from_numpy(f), plan).numpy(),
        np.asarray(jfp_cone.fp_cone_sf_pallas(jnp.asarray(f), jg, bu=8, bv=8)),
        **TOL)
    np.testing.assert_allclose(
        fp_cone.bp_cone_sf(torch.from_numpy(y), plan).numpy(),
        np.asarray(jfp_cone.bp_cone_sf_pallas(jnp.asarray(y), jg, bg=8, bv=8)),
        **TOL)


def test_batched_4d_and_chunking_match_per_sample(monkeypatch):
    _, tg = _pair(CONE_SHAPES[1])
    plan = ConePlan(tg)
    f = _data((2,) + tg.vol.shape, 4)
    y = _data((2,) + tg.sino_shape, 5)
    fb = fp_cone.fp_cone_sf(torch.from_numpy(f), plan)
    bb = fp_cone.bp_cone_sf(torch.from_numpy(y), plan)
    # chunks of one view and a few z slices give the same sums
    monkeypatch.setattr(fp_cone, "_CHUNK_ELEMS", 2 * 24 * 24 * 3)
    assert len(list(fp_cone._chunks(plan, 2, 3, 24 * 24))) > 3
    np.testing.assert_allclose(fp_cone.fp_cone_sf(torch.from_numpy(f), plan).numpy(),
                               fb.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fp_cone.bp_cone_sf(torch.from_numpy(y), plan).numpy(),
                               bb.numpy(), rtol=1e-5, atol=1e-5)
    for i in range(2):
        np.testing.assert_allclose(
            fb[i].numpy(), fp_cone.fp_cone_sf(torch.from_numpy(f[i]), plan).numpy(),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            bb[i].numpy(), fp_cone.bp_cone_sf(torch.from_numpy(y[i]), plan).numpy(),
            rtol=1e-5, atol=1e-5)


def test_bf16_within_bound_of_reference():
    jg, tg = _pair(CONE_SHAPES[0])
    plan = ConePlan(tg)
    f, y = _data(tg.vol.shape, 6), _data(tg.sino_shape, 7)
    p_ref = np.asarray(jref.forward(jnp.asarray(f), jg, dtype="bfloat16"))
    b_ref = np.asarray(jref.adjoint(jnp.asarray(y), jg, dtype="bfloat16"))
    p = fp_cone.fp_cone_sf(torch.from_numpy(f), plan, compute_dtype="bf16")
    b = fp_cone.bp_cone_sf(torch.from_numpy(y), plan, compute_dtype="bf16")
    assert p.dtype == torch.float32 and b.dtype == torch.float32
    for got, want in ((p.numpy(), p_ref), (b.numpy(), b_ref)):
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < precision.BF16_FP_REL_BOUND, rel
    assert not torch.equal(p, fp_cone.fp_cone_sf(torch.from_numpy(f), plan))


def test_dot_gradient_and_double_backward():
    _, tg = _pair(CONE_SHAPES[2])
    proj = Projector(ProjectorSpec(tg), device="cpu")
    x = torch.from_numpy(_data(tg.vol.shape, 8))
    y = torch.from_numpy(_data(tg.sino_shape, 9))
    lhs = float((proj(x).double() * y.double()).sum())
    rhs = float((x.double() * proj.T(y).double()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - y) ** 2), xg,
                                  create_graph=True)
    torch.testing.assert_close(grad, proj.T(proj(x) - y), rtol=1e-4, atol=1e-5)
    v = torch.from_numpy(_data(tg.vol.shape, 10))
    (hv,) = torch.autograd.grad(torch.sum(grad * v), xg)
    torch.testing.assert_close(hv, proj.T(proj(v)), rtol=1e-4, atol=1e-5)


def test_curved_cone_raises_not_implemented():
    g = tgeo.cone_beam(4, 4, 12, tgeo.VolumeGeometry(8, 8, 4), sod=40.0,
                       sdd=80.0, pixel_width=2.0, detector_type="curved")
    # no SF pair on a curved detector, as in the reference (model="joseph"
    # projects it: tests/test_torch_joseph.py)
    with pytest.raises(NotImplementedError, match="flat detectors"):
        ConePlan(g)
    proj = Projector(ProjectorSpec(g), device="cpu")
    with pytest.raises(NotImplementedError, match="flat detectors"):
        proj(torch.zeros(g.vol.shape))
