"""The port's fan-beam SF pair (the CPU path of the kernel wrappers, and the
``ref`` backend) against the reference package: its per-view tables, its
plain oracle ``ref.forward``/``ref.adjoint`` and its Pallas kernels in
interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
from repro.kernels import fp_cone as jfp_cone
from repro.kernels import ref as jref
from repro.kernels.fp_fan import bp_fan_sf_pallas, fp_fan_sf_pallas

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec
from repro_torch.kernels import fp_cone, fp_fan, precision
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fp_fan import FanPlan

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


GEOMS = {
    # n_angles, n_rows, n_cols, (nx, ny, nz), fan_beam kwargs
    # tests/test_fan.py:34-38
    "flat": (6, 4, 24, (16, 16, 4), dict(sod=80.0, sdd=160.0, pixel_width=2.0)),
    "curved": (5, 2, 36, (24, 24, 2), dict(sod=120.0, sdd=200.0, pixel_width=2.0,
                                           detector_type="curved")),
    # tests/test_fan.py:63-78: the footprint windows do not span the axis
    "windowed_flat": (4, 1, 128, (48, 48, 1), dict(sod=200.0, sdd=220.0,
                                                   pixel_width=1.0)),
    "windowed_curved": (4, 1, 128, (48, 48, 1), dict(
        sod=200.0, sdd=220.0, pixel_width=1.0, detector_type="curved")),
}


def _pair(name):
    na, nv, nu, vs, kw = GEOMS[name]
    return (jgeo.fan_beam(na, nv, nu, jgeo.VolumeGeometry(*vs), **kw),
            tgeo.fan_beam(na, nv, nu, tgeo.VolumeGeometry(*vs), **kw))


def _data(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("det", ["flat", "curved"])
def test_view_params_cone_bit_identical(det):
    kw = dict(dx=1.5, dy=1.5, dz=2.0, offset_x=1.3, offset_y=-0.7)
    angles = np.linspace(0.0, 2 * np.pi, 23, endpoint=False) + 0.01
    g_j = jgeo.fan_beam(23, 3, 40, jgeo.VolumeGeometry(20, 20, 3, **kw),
                        sod=90.0, sdd=170.0, pixel_width=2.0, angles=angles,
                        detector_type=det)
    g_t = tgeo.fan_beam(23, 3, 40, tgeo.VolumeGeometry(20, 20, 3, **kw),
                        sod=90.0, sdd=170.0, pixel_width=2.0, angles=angles,
                        detector_type=det)
    for a, b in zip(fp_cone._view_params_cone(g_t),
                    jfp_cone._view_params_cone(g_j)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert fp_cone._mag_bounds(g_t) == jfp_cone._mag_bounds(g_j)


@pytest.mark.parametrize("name", list(GEOMS))
def test_fp_bp_match_reference_oracle(name):
    jg, tg = _pair(name)
    plan = FanPlan(tg)
    f, y = _data(tg.vol.shape, 0), _data(tg.sino_shape, 1)
    p_ref = np.asarray(jref.forward(jnp.asarray(f), jg))
    b_ref = np.asarray(jref.adjoint(jnp.asarray(y), jg))
    np.testing.assert_allclose(
        fp_fan.fp_fan_sf(torch.from_numpy(f), plan).numpy(), p_ref, **TOL)
    np.testing.assert_allclose(
        fp_fan.bp_fan_sf(torch.from_numpy(y), plan).numpy(), b_ref, **TOL)
    np.testing.assert_allclose(
        tref.forward(torch.from_numpy(f), tg).numpy(), p_ref, **TOL)
    np.testing.assert_allclose(
        tref.adjoint(torch.from_numpy(y), tg).numpy(), b_ref, **TOL)


@pytest.mark.parametrize("name", ["flat", "windowed_curved"])
def test_fp_bp_match_pallas_interpret(name):
    jg, tg = _pair(name)
    plan = FanPlan(tg)
    f, y = _data(tg.vol.shape, 2), _data(tg.sino_shape, 3)
    np.testing.assert_allclose(
        fp_fan.fp_fan_sf(torch.from_numpy(f), plan).numpy(),
        np.asarray(fp_fan_sf_pallas(jnp.asarray(f), jg)), **TOL)
    np.testing.assert_allclose(
        fp_fan.bp_fan_sf(torch.from_numpy(y), plan).numpy(),
        np.asarray(bp_fan_sf_pallas(jnp.asarray(y), jg)), **TOL)


def test_batched_4d_matches_per_sample():
    _, tg = _pair("curved")
    plan = FanPlan(tg)
    f = _data((3,) + tg.vol.shape, 4)
    y = _data((3,) + tg.sino_shape, 5)
    fb = fp_fan.fp_fan_sf(torch.from_numpy(f), plan)
    bb = fp_fan.bp_fan_sf(torch.from_numpy(y), plan)
    for i in range(3):
        np.testing.assert_array_equal(
            fb[i].numpy(), fp_fan.fp_fan_sf(torch.from_numpy(f[i]), plan).numpy())
        np.testing.assert_allclose(
            bb[i].numpy(), fp_fan.bp_fan_sf(torch.from_numpy(y[i]), plan).numpy(),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["flat", "curved"])
def test_bf16_within_bound_of_reference(name):
    jg, tg = _pair(name)
    plan = FanPlan(tg)
    f, y = _data(tg.vol.shape, 6), _data(tg.sino_shape, 7)
    p_ref = np.asarray(jref.forward(jnp.asarray(f), jg, dtype="bfloat16"))
    b_ref = np.asarray(jref.adjoint(jnp.asarray(y), jg, dtype="bfloat16"))
    p = fp_fan.fp_fan_sf(torch.from_numpy(f), plan, compute_dtype="bf16")
    b = fp_fan.bp_fan_sf(torch.from_numpy(y), plan, compute_dtype="bf16")
    assert p.dtype == torch.float32 and b.dtype == torch.float32
    for got, want in ((p.numpy(), p_ref), (b.numpy(), b_ref)):
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < precision.BF16_FP_REL_BOUND, rel
    assert not torch.equal(p, fp_fan.fp_fan_sf(torch.from_numpy(f), plan))


@pytest.mark.parametrize("name", ["flat", "windowed_curved"])
def test_dot_gradient_and_double_backward(name):
    _, tg = _pair(name)
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
    # d/dx <grad(x), v> = A^T A v
    v = torch.from_numpy(_data(tg.vol.shape, 10))
    (hv,) = torch.autograd.grad(torch.sum(grad * v), xg)
    torch.testing.assert_close(hv, proj.T(proj(v)), rtol=1e-4, atol=1e-5)


def test_parallel_limit():
    """sod -> inf reduces the fan transform to the parallel one
    (tests/test_fan.py:90-100)."""
    v = tgeo.VolumeGeometry(24, 24, 2)
    gp = tgeo.parallel_beam(8, 2, 36, v, angular_range=360.0)
    gf = tgeo.fan_beam(8, 2, 36, v, sod=1e5, sdd=2e5, pixel_width=2.0,
                       angular_range=360.0)
    f = torch.from_numpy(np.random.default_rng(0).uniform(
        size=v.shape).astype(np.float32))
    pf, pp = tref.forward(f, gf), tref.forward(f, gp)
    err = float((pf - pp).abs().max() / pp.abs().max())
    assert err < 1e-3, err
