"""The port's parallel SF pair (the CPU path of the kernel wrappers, and the
``ref`` backend) against the reference package: its plain oracle
``ref.forward``/``ref.adjoint`` and its Pallas kernels in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
from repro.kernels import ref as jref
from repro.kernels.fp_par import bp_parallel_sf_pallas, fp_parallel_sf_pallas

import repro_torch.core.geometry as tgeo
from repro_torch import kernels
from repro_torch.kernels import fp_cone, fp_fan, fp_par, precision
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fp_cone import ConePlan
from repro_torch.kernels.fp_fan import FanPlan
from repro_torch.kernels.fp_par import ParallelPlan

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
    # nx, ny, nz, na, nv, nu, volume kwargs, detector kwargs
    "cube": (16, 16, 4, 6, 4, 24, {}, {}),
    "ragged": (24, 24, 2, 5, 2, 40, {}, {}),
    "offset_aniso": (20, 20, 4, 8, 6, 30,
                     dict(dx=1.5, dy=1.5, dz=2.0, offset_x=1.3, offset_y=-0.8),
                     dict(pixel_width=1.1, pixel_height=1.3, center_col=0.4)),
}


def _pair(name):
    nx, ny, nz, na, nv, nu, vk, dk = GEOMS[name]
    return (jgeo.parallel_beam(na, nv, nu, jgeo.VolumeGeometry(nx, ny, nz, **vk), **dk),
            tgeo.parallel_beam(na, nv, nu, tgeo.VolumeGeometry(nx, ny, nz, **vk), **dk))


def _data(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", list(GEOMS))
def test_fp_bp_match_reference_oracle(name):
    jg, tg = _pair(name)
    plan = ParallelPlan(tg)
    f, y = _data(tg.vol.shape, 0), _data(tg.sino_shape, 1)
    p_ref = np.asarray(jref.forward(jnp.asarray(f), jg))
    b_ref = np.asarray(jref.adjoint(jnp.asarray(y), jg))
    np.testing.assert_allclose(
        fp_par.fp_parallel_sf(torch.from_numpy(f), plan).numpy(), p_ref, **TOL)
    np.testing.assert_allclose(
        fp_par.bp_parallel_sf(torch.from_numpy(y), plan).numpy(), b_ref, **TOL)
    np.testing.assert_allclose(
        tref.forward(torch.from_numpy(f), tg).numpy(), p_ref, **TOL)
    np.testing.assert_allclose(
        tref.adjoint(torch.from_numpy(y), tg).numpy(), b_ref, **TOL)


def test_fp_bp_match_pallas_interpret():
    jg, tg = _pair("cube")
    plan = ParallelPlan(tg)
    f, y = _data(tg.vol.shape, 2), _data(tg.sino_shape, 3)
    np.testing.assert_allclose(
        fp_par.fp_parallel_sf(torch.from_numpy(f), plan).numpy(),
        np.asarray(fp_parallel_sf_pallas(jnp.asarray(f), jg)), **TOL)
    np.testing.assert_allclose(
        fp_par.bp_parallel_sf(torch.from_numpy(y), plan).numpy(),
        np.asarray(bp_parallel_sf_pallas(jnp.asarray(y), jg)), **TOL)


def test_batched_4d_matches_pallas_and_per_sample():
    jg, tg = _pair("cube")
    plan = ParallelPlan(tg)
    f = _data((3,) + tg.vol.shape, 4)
    y = _data((3,) + tg.sino_shape, 5)
    fb = fp_par.fp_parallel_sf(torch.from_numpy(f), plan)
    bb = fp_par.bp_parallel_sf(torch.from_numpy(y), plan)
    np.testing.assert_allclose(
        fb.numpy(), np.asarray(fp_parallel_sf_pallas(jnp.asarray(f), jg)), **TOL)
    np.testing.assert_allclose(
        bb.numpy(), np.asarray(bp_parallel_sf_pallas(jnp.asarray(y), jg)), **TOL)
    for i in range(3):
        np.testing.assert_array_equal(
            fb[i].numpy(), fp_par.fp_parallel_sf(torch.from_numpy(f[i]), plan).numpy())
    np.testing.assert_allclose(tref.forward(torch.from_numpy(f), tg).numpy(),
                               fb.numpy(), **TOL)


@pytest.mark.parametrize("name", ["cube", "offset_aniso"])
def test_bf16_within_bound_of_reference(name):
    jg, tg = _pair(name)
    plan = ParallelPlan(tg)
    f, y = _data(tg.vol.shape, 6), _data(tg.sino_shape, 7)
    p_ref = np.asarray(jref.forward(jnp.asarray(f), jg, dtype="bfloat16"))
    b_ref = np.asarray(jref.adjoint(jnp.asarray(y), jg, dtype="bfloat16"))
    p = fp_par.fp_parallel_sf(torch.from_numpy(f), plan, compute_dtype="bf16")
    b = fp_par.bp_parallel_sf(torch.from_numpy(y), plan, compute_dtype="bf16")
    assert p.dtype == torch.float32 and b.dtype == torch.float32
    for got, want in ((p.numpy(), p_ref), (b.numpy(), b_ref)):
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < precision.BF16_FP_REL_BOUND, rel
    # the tile cast happened: bf16 differs from the f32 run
    assert not torch.equal(p, fp_par.fp_parallel_sf(torch.from_numpy(f), plan))


def test_wrappers_count_no_launch_on_cpu_and_reject_bad_shapes():
    _, tg = _pair("cube")
    plan = ParallelPlan(tg)
    vol = tgeo.VolumeGeometry(8, 8, 4)
    fan = FanPlan(tgeo.fan_beam(4, 4, 12, vol, sod=40.0, sdd=80.0,
                                pixel_width=2.0, detector_type="curved"))
    cone = ConePlan(tgeo.cone_beam(4, 4, 12, vol, sod=40.0, sdd=80.0,
                                   pixel_width=2.0))
    kernels.reset_launches()
    fp_par.fp_parallel_sf(torch.zeros(tg.vol.shape), plan)
    fp_par.bp_parallel_sf(torch.zeros(tg.sino_shape), plan)
    for fp, bp, p in ((fp_fan.fp_fan_sf, fp_fan.bp_fan_sf, fan),
                      (fp_cone.fp_cone_sf, fp_cone.bp_cone_sf, cone)):
        fp(torch.zeros((2,) + vol.shape), p)
        bp(torch.zeros((2,) + p.geom.sino_shape), p)
    assert fp_par.LAUNCHES == {"fp_par_sf": 0, "bp_par_sf": 0}
    assert kernels.launches() == {k: 0 for k in (
        "fp_par_sf", "bp_par_sf", "fp_fan_sf", "bp_fan_sf", "fp_cone_sf",
        "bp_cone_sf", "fp_modular_sf", "bp_modular_sf", "flash_fwd",
        "flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv")}
    with pytest.raises(ValueError):
        fp_cone.fp_cone_sf(torch.zeros(vol.shape[:2]), cone)
    with pytest.raises(ValueError):
        FanPlan(tg)
    with pytest.raises(ValueError):
        ConePlan(fan.geom)
    with pytest.raises(ValueError):
        fp_par.fp_parallel_sf(torch.zeros(tg.vol.shape[:2]), plan)
    with pytest.raises(ValueError):
        fp_par._check_tile(torch.zeros(2, 2, 2), (2, 2, 2), "fp_par_sf")
    with pytest.raises(ValueError):
        ParallelPlan(tgeo.cone_beam(4, 4, 8, tgeo.VolumeGeometry(8, 8, 4),
                                    sod=40.0, sdd=80.0))
