"""The port's Joseph projectors (``kernels/ref.py``: parallel, cone on a flat
and a curved detector, modular ray marching) against the reference
package's (``repro.kernels.ref.forward`` / ``adjoint`` with
``model="joseph"``) at 2e-4, with the dot test, gradient = backprojection
and double backward through ``Projector``; tilted modular frames under
``model="sf"`` run the Joseph ray-marcher in both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
import repro.kernels  # noqa: F401  (registers the reference's modular oracle)
from repro.kernels import ref as jref

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec, resolve_mode
from repro_torch import kernels as tkernels
from repro_torch.kernels import fp_modular
from repro_torch.kernels import ref as tref

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tilted(G, na=8):
    """The two tilted arcs of examples/iterative_recon.py, cut to ``na``
    views over a 12 x 12 x 6 volume."""
    ang = np.linspace(0, 2 * np.pi, na, endpoint=False)
    tilt = 0.15 * np.sin(2 * ang)
    src = np.stack([60 * np.cos(ang), 60 * np.sin(ang), 12 * tilt], -1)
    eu = np.stack([-np.sin(ang), np.cos(ang), np.zeros_like(ang)], -1)
    ev = np.cross(src / np.linalg.norm(src, axis=1, keepdims=True), eu)
    return G.modular_beam(src, -src, eu, ev, n_rows=8, n_cols=20,
                          vol=G.VolumeGeometry(12, 12, 6), pixel_width=2.0,
                          pixel_height=2.0)


# Angles off the 45-degree ties, where the driving axis is decided by the
# last bit of cos and sin.
GEOMS = {
    "parallel": lambda G: G.parallel_beam(
        10, 5, 20, G.VolumeGeometry(12, 14, 4, offset_x=0.7), pixel_width=1.3,
        pixel_height=1.1),
    "cone_flat": lambda G: G.cone_beam(
        10, 6, 24, G.VolumeGeometry(12, 14, 4), sod=80.0, sdd=160.0,
        pixel_width=1.5, pixel_height=1.5),
    "cone_curved": lambda G: G.cone_beam(
        10, 6, 24, G.VolumeGeometry(12, 14, 4), sod=80.0, sdd=160.0,
        pixel_width=1.5, pixel_height=1.5, detector_type="curved"),
    "modular_tilted": _tilted,
    "modular_helical": lambda G: G.helical_beam(
        1.0, 8.0, 6, 6, 20, G.VolumeGeometry(12, 12, 6), sod=60.0, sdd=120.0,
        pixel_width=2.0, pixel_height=2.0),
}


def _data(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", list(GEOMS))
def test_joseph_matches_the_reference(name):
    jg, tg = GEOMS[name](jgeo), GEOMS[name](tgeo)
    f = _data((2,) + tg.vol.shape, 0)
    y = _data((2,) + tg.sino_shape, 1)
    want_fp = np.stack([np.asarray(jref.forward(jnp.asarray(x), jg, "joseph"))
                        for x in f])
    want_bp = np.stack([np.asarray(jref.adjoint(jnp.asarray(x), jg, "joseph"))
                        for x in y])
    np.testing.assert_allclose(
        tref.forward(torch.from_numpy(f), tg, "joseph").numpy(), want_fp, **TOL)
    np.testing.assert_allclose(
        tref.adjoint(torch.from_numpy(y), tg, "joseph").numpy(), want_bp, **TOL)
    # one sample at a time, unbatched, through the public function
    fn = {"parallel": tref.fp_parallel_joseph, "cone": tref.fp_cone_joseph,
          "modular": tref.fp_modular_joseph}[tg.geom_type]
    np.testing.assert_allclose(fn(torch.from_numpy(f[1]), tg).numpy(),
                               want_fp[1], **TOL)


@pytest.mark.parametrize("name", list(GEOMS))
def test_joseph_pair_dot_test_gradient_and_double_backward(name):
    g = GEOMS[name](tgeo)
    proj = Projector(ProjectorSpec(g, model="joseph"), device="cpu")
    x = torch.from_numpy(_data((2,) + g.vol.shape, 2))
    y = torch.from_numpy(_data((2,) + g.sino_shape, 3))
    lhs = float(torch.sum(proj(x).double() * y.double()))
    rhs = float(torch.sum(x.double() * proj.T(y).double()))
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - y) ** 2), xg,
                                  create_graph=True)
    torch.testing.assert_close(grad, proj.T(proj(x) - y), rtol=1e-4, atol=1e-5)
    v = torch.from_numpy(_data((2,) + g.vol.shape, 4))
    (hv,) = torch.autograd.grad(torch.sum(grad * v), xg)
    torch.testing.assert_close(hv, proj.T(proj(v)), rtol=1e-4, atol=1e-5)


def test_view_chunks_give_the_same_sums(monkeypatch):
    """Chunks of one view (the adjoint takes each chunk's VJP on its own)
    give the sums of the whole."""
    for name in ("cone_curved", "modular_tilted"):
        g = GEOMS[name](tgeo)
        x = torch.from_numpy(_data((2,) + g.vol.shape, 5))
        y = torch.from_numpy(_data((2,) + g.sino_shape, 6))
        fp, bp = tref.forward(x, g, "joseph"), tref.adjoint(y, g, "joseph")
        monkeypatch.setattr(tref, "_CHUNK_ELEMS", 1)
        torch.testing.assert_close(tref.forward(x, g, "joseph"), fp, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(tref.adjoint(y, g, "joseph"), bp, rtol=1e-5,
                                   atol=1e-5)
        monkeypatch.undo()


def test_tilted_modular_sf_is_joseph_in_both_packages():
    jg, tg = _tilted(jgeo), _tilted(tgeo)
    assert not fp_modular.modular_frames_axial(tg)
    f = _data(tg.vol.shape, 7)
    j_sf = np.asarray(jref.forward(jnp.asarray(f), jg, "sf"))
    j_jo = np.asarray(jref.forward(jnp.asarray(f), jg, "joseph"))
    np.testing.assert_array_equal(j_sf, j_jo)
    x = torch.from_numpy(f)
    assert torch.equal(tref.forward(x, tg, "sf"), tref.forward(x, tg, "joseph"))
    np.testing.assert_allclose(tref.forward(x, tg, "sf").numpy(), j_sf, **TOL)
    assert isinstance(tref._plan(tg, "sf"), tref.JosephPlan)


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_joseph_runs_on_auto_and_ref_without_kernels(backend):
    """No kernel pair exists for the Joseph model: ``auto`` and ``ref`` run
    the plain pair (on the tensor's device), ``cuda`` refuses it; every
    Joseph spec resolves to the exact pair."""
    g = GEOMS["cone_curved"](tgeo)
    x = torch.from_numpy(_data(g.vol.shape, 8))
    tkernels.reset_launches()
    out = Projector(ProjectorSpec(g, model="joseph", backend=backend),
                    device="cpu")(x)
    torch.testing.assert_close(out, tref.forward(x, g, "joseph"), rtol=0,
                               atol=0)
    assert not any(tkernels.launches().values())
    assert resolve_mode(g, "joseph", backend) == "exact"
    with pytest.raises(NotImplementedError, match="no CUDA kernel pair"):
        Projector(ProjectorSpec(g, model="joseph", backend="cuda"),
                  device="cpu")(x)
    # no Joseph fan beam in either package
    fan = tgeo.fan_beam(4, 1, 16, tgeo.VolumeGeometry(8, 8, 1), sod=40.0,
                        sdd=80.0)
    with pytest.raises(NotImplementedError):
        Projector(ProjectorSpec(fan, model="joseph", backend=backend),
                  device="cpu")(torch.zeros(fan.vol.shape))
