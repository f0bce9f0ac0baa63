"""The port's fan-beam FBP (flat, curved, Parker short scan) and FDK against
the reference package, and their quantitative disc checks."""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
import repro.core.filters as jfilters
from repro.core.fbp import fbp as j_fbp
from repro.core.fbp import parker_weights as j_parker_weights

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec
import repro_torch.core.filters as tfilters
from repro_torch.core.fbp import fbp as t_fbp
from repro_torch.core.fbp import parker_weights as t_parker_weights
from repro_torch.data.metrics import psnr
from repro_torch.data.phantoms import shepp_logan_2d


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _short_range(n_cols, pixel_width, sdd):
    return math.degrees(math.pi + 2 * math.atan((n_cols - 1) / 2 * pixel_width / sdd))


def _fan(G, det, short=False):
    rng = _short_range(40, 2.0, 160.0) if short else 360.0
    return G.fan_beam(48, 2, 40, G.VolumeGeometry(24, 24, 2), sod=80.0,
                      sdd=160.0, pixel_width=2.0, detector_type=det,
                      angular_range=rng)


@pytest.mark.parametrize("det", ["flat", "curved"])
def test_parker_weights_match_reference(det):
    assert np.array_equal(t_parker_weights(_fan(tgeo, det, short=True)),
                          j_parker_weights(_fan(jgeo, det, short=True)))


@pytest.mark.parametrize("sdd", [0.0, 160.0])
@pytest.mark.parametrize("name", ["ramp", "hann"])
def test_ramp_kernel_matches_reference(name, sdd):
    assert np.array_equal(tfilters.ramp_kernel_freq(128, 2.0, name, sdd),
                          jfilters.ramp_kernel_freq(128, 2.0, name, sdd))


@pytest.mark.parametrize("det,short", [("flat", False), ("curved", False),
                                       ("flat", True), ("curved", True)])
def test_fbp_fan_matches_reference(det, short):
    jg, tg = _fan(jgeo, det, short), _fan(tgeo, det, short)
    y = np.random.default_rng(0).normal(size=tg.sino_shape).astype(np.float32)
    want = np.asarray(j_fbp(jnp.asarray(y), jg))
    got = t_fbp(torch.from_numpy(y), tg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # an explicit short_scan=False on a short scan is the naive weighting
    if short:
        want = np.asarray(j_fbp(jnp.asarray(y), jg, short_scan=False))
        got = t_fbp(torch.from_numpy(y), tg, short_scan=False).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_fbp_cone_matches_reference_and_batches(monkeypatch):
    kw = dict(sod=80.0, sdd=160.0, pixel_width=2.0, pixel_height=2.0)
    jg = jgeo.cone_beam(24, 12, 36, jgeo.VolumeGeometry(20, 20, 6), **kw)
    tg = tgeo.cone_beam(24, 12, 36, tgeo.VolumeGeometry(20, 20, 6), **kw)
    y = np.random.default_rng(1).normal(size=(2,) + tg.sino_shape).astype(np.float32)
    want = np.asarray(j_fbp(jnp.asarray(y[0]), jg))
    got = t_fbp(torch.from_numpy(y), tg).numpy()
    np.testing.assert_allclose(got[0], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # chunks over views and voxel columns give the same sums
    monkeypatch.setattr(importlib.import_module("repro_torch.core.fbp"),
                        "_CHUNK_ELEMS", 2 * 12 * 50)
    np.testing.assert_allclose(t_fbp(torch.from_numpy(y), tg).numpy(),
                               got, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError):
        t_fbp(torch.from_numpy(y[0]), tgeo.cone_beam(
            24, 12, 36, tgeo.VolumeGeometry(20, 20, 6), detector_type="curved",
            **kw))


def _disc(vol, r, nz):
    X, Y = np.meshgrid(vol.x_coords(), vol.y_coords(), indexing="ij")
    f = (0.02 * ((X ** 2 + Y ** 2) <= r ** 2)).astype(np.float32)
    return torch.from_numpy(np.repeat(f[:, :, None], nz, axis=2))


@pytest.mark.parametrize("det", ["flat", "curved"])
def test_fan_fbp_quantitative_disc(det):
    """tests/test_fan.py:106-119, through the port."""
    vol = tgeo.VolumeGeometry(64, 64, 2)
    g = tgeo.fan_beam(180, 2, 112, vol, sod=180.0, sdd=360.0, pixel_width=2.0,
                      angular_range=360.0, detector_type=det)
    proj = Projector(ProjectorSpec(g), device="cpu")
    rec = proj.fbp(proj(_disc(vol, 12.0, 2)))
    center = float(rec[28:36, 28:36, 1].mean())
    assert abs(center / 0.02 - 1.0) < 0.05, (det, center)


def test_fan_parker_short_scan_beats_naive():
    """tests/test_fan.py:142-157, through the port."""
    vol = tgeo.VolumeGeometry(64, 64, 1)
    f = torch.from_numpy(shepp_logan_2d(vol)[:, :, None]) * 0.02
    g = tgeo.fan_beam(144, 1, 96, vol, sod=200.0, sdd=400.0, pixel_width=2.0,
                      angular_range=_short_range(96, 2.0, 400.0))
    proj = Projector(ProjectorSpec(g), device="cpu")
    sino = proj(f)
    parker = psnr(proj.fbp(sino), f)
    naive = psnr(proj.fbp(sino, short_scan=False), f)
    assert parker > 20.0 and parker > naive + 4.0, (parker, naive)


def test_fdk_quantitative_cone():
    """tests/test_accuracy.py:82-93, through the port."""
    vol = tgeo.VolumeGeometry(96, 96, 4)
    g = tgeo.cone_beam(240, 16, 160, vol, sod=250.0, sdd=500.0,
                       pixel_width=2.0, pixel_height=2.0)
    proj = Projector(ProjectorSpec(g), device="cpu")
    rec = proj.fbp(proj(_disc(vol, 15.0, 4)))
    center = float(rec[42:54, 42:54, 2].mean())
    assert abs(center / 0.02 - 1.0) < 0.05, center
