"""The port's FBP, SIRT and quickstart flow against the reference package."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.data.metrics import psnr as jpsnr
from repro.data.phantoms import shepp_logan_2d as j_shepp_logan
from repro.recon import sirt as jsirt

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec
from repro_torch.data import metrics as tmetrics
from repro_torch.data.phantoms import shepp_logan_2d
from repro_torch.recon import sirt

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _small():
    jg = jcore.parallel_beam(45, 1, 48, jcore.VolumeGeometry(32, 32, 1))
    tg = tgeo.parallel_beam(45, 1, 48, tgeo.VolumeGeometry(32, 32, 1))
    f = shepp_logan_2d(tg.vol)[:, :, None] * np.float32(0.02)
    return jg, tg, f


def test_fbp_parallel_matches_reference():
    jg, tg, f = _small()
    jp = jcore.Projector(jcore.ProjectorSpec(jg))
    tp = Projector(ProjectorSpec(tg), device="cpu")
    y = np.array(jp(jnp.asarray(f)))
    want = np.asarray(jp.fbp(jnp.asarray(y)))
    got = tp.fbp(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # leading batch dims reconstruct sample by sample
    yb = np.stack([y, 2 * y])
    gb = tp.fbp(torch.from_numpy(yb)).numpy()
    np.testing.assert_allclose(gb[1], 2 * got, rtol=1e-5, atol=1e-7)


def test_sirt_matches_reference():
    jg, tg, f = _small()
    y = np.array(jcore.Projector(jcore.ProjectorSpec(jg))(jnp.asarray(f)))
    want = jsirt(jcore.ProjectorSpec(jg), jnp.asarray(y), n_iters=10)
    got = sirt(ProjectorSpec(tg), torch.from_numpy(y), n_iters=10)
    wi = np.asarray(want.image)
    np.testing.assert_allclose(got.image.numpy(), wi, rtol=0,
                               atol=1e-4 * np.abs(wi).max())
    wh = np.asarray(want.residual_history)
    assert got.residual_history.shape == wh.shape == (10,)
    np.testing.assert_allclose(got.residual_history.numpy(), wh, rtol=1e-4)
    assert got.iterations == 10


def _load_quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_flow_matches_reference():
    """examples/quickstart.py's flow at 64^2 (20 SIRT iterations): FBP and
    SIRT PSNR agree with the reference package's within 0.05 dB, and the
    gradient check holds."""
    n, na, iters = 64, 90, 20
    vol = jcore.VolumeGeometry(n, n, 1)
    jg = jcore.parallel_beam(na, 1, int(1.5 * n), vol, angular_range=180.0)
    spec = jcore.ProjectorSpec(jg)
    proj = jcore.Projector(spec)
    f = jnp.asarray(j_shepp_logan(vol)[:, :, None]) * 0.02
    sino = proj(f)
    want_fbp = jpsnr(proj.fbp(sino), f, 0.02)
    want_sirt = jpsnr(jsirt(spec, sino, n_iters=iters).image, f, 0.02)
    got = _load_quickstart().main("cpu", n=n, n_angles=na, n_iters=iters)
    assert abs(got["fbp_psnr"] - want_fbp) < 0.05
    assert abs(got["sirt_psnr"] - want_sirt) < 0.05
    assert got["grad_ok"]
    jax.clear_caches()


def test_metrics_take_tensors():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(16, 16)).astype(np.float32)
    b = a + rng.normal(scale=0.05, size=a.shape).astype(np.float32)
    assert tmetrics.psnr(torch.from_numpy(b), torch.from_numpy(a)) == \
        tmetrics.psnr(b, a)
    assert abs(tmetrics.ssim(torch.from_numpy(b), a) - tmetrics.ssim(b, a)) < 1e-12
