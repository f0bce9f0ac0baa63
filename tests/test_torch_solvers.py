"""The port's CGLS, FISTA-TV, power iteration and data-consistency
refinement against the reference package, on a small parallel geometry and
a small helical one (the modular pair), and the helical example's imports.

Both packages get the same numpy inputs.  The projectors agree to ~1e-6;
CG-type iterations amplify that as they converge (most on the well-posed
parallel case), so images are held to 5e-4 relative and residual
histories to 5e-3.  ``power_iteration`` draws its start with a
``torch.Generator`` where the reference uses ``jax.random``, so FISTA-TV is
run with one Lipschitz constant given to both, and the two estimates are
compared at 3 %."""
import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.recon as jrecon

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec
from repro_torch import recon

# the packages export the function fista_tv under the modules' own name
jfista_mod = importlib.import_module("repro.recon.fista_tv")
tfista_mod = importlib.import_module("repro_torch.recon.fista_tv")

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMG_TOL, HIST_TOL = 5e-4, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _parallel(G):
    return G.parallel_beam(12, 2, 24, G.VolumeGeometry(16, 16, 2))


def _helical(G):
    return G.helical_beam(1.0, 8.0, 8, 10, 24, G.VolumeGeometry(16, 16, 8),
                          sod=80.0, sdd=160.0, pixel_width=2.0,
                          pixel_height=2.0)


GEOMS = {"parallel": _parallel, "helical": _helical}


def _problem(name):
    """Both packages' projectors, a phantom, its noisy sinogram (numpy) and
    a mask keeping every other view."""
    jg, tg = GEOMS[name](jcore), GEOMS[name](tgeo)
    jp = jcore.Projector(jcore.ProjectorSpec(jg))
    tp = Projector(ProjectorSpec(tg), device="cpu")
    f = np.zeros(tg.vol.shape, np.float32)
    f[4:11, 5:12, :] = 0.02
    f[8:13, 2:6, tg.vol.nz // 2:] = 0.03
    y = np.asarray(jp(jnp.asarray(f)))
    y = y + np.random.default_rng(0).normal(
        scale=0.01 * float(y.max()), size=y.shape).astype(np.float32)
    mask = np.zeros(tg.sino_shape, np.float32)
    mask[::2] = 1.0
    return jp, tp, f, y, mask


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("name,damp,masked", [
    ("parallel", 0.0, False), ("parallel", 0.05, False),
    ("parallel", 0.0, True), ("helical", 0.05, True)])
def test_cgls_matches_reference(name, damp, masked):
    jp, tp, _, y, mask = _problem(name)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = jrecon.cgls(jp, jnp.asarray(y), n_iters=10, damp=damp, mask=jm)
    got = recon.cgls(tp, torch.from_numpy(y), n_iters=10, damp=damp, mask=tm)
    assert got.iterations == 10
    assert tuple(got.residual_history.shape) == (10,)
    assert _rel(got.image, want.image) < IMG_TOL
    assert _rel(got.residual_history, want.residual_history) < HIST_TOL
    hist = got.residual_history.numpy()
    assert np.all(hist[1:] <= hist[:-1])                 # CG: non-increasing


def test_cgls_batch_is_per_sample():
    _, tp, _, y, _ = _problem("parallel")
    yb = torch.from_numpy(np.stack([y, 0.5 * y]))
    got = recon.cgls(tp, yb, n_iters=5)
    assert tuple(got.residual_history.shape) == (2, 5)
    one = recon.cgls(tp, yb[1], n_iters=5)
    torch.testing.assert_close(got.image[1], one.image, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", GEOMS)
def test_fista_tv_matches_reference_with_one_lipschitz_constant(name):
    jp, tp, _, y, mask = _problem(name)
    L = 1.05 * float(recon.power_iteration(tp))
    want = jrecon.fista_tv(jp, jnp.asarray(y), n_iters=10, beta=1e-3, L=L,
                           mask=jnp.asarray(mask))
    got = recon.fista_tv(tp, torch.from_numpy(y), n_iters=10, beta=1e-3, L=L,
                         mask=torch.from_numpy(mask))
    assert _rel(got.image, want.image) < IMG_TOL
    assert _rel(got.residual_history, want.residual_history) < HIST_TOL
    assert float(got.image.min()) >= 0.0


@pytest.mark.parametrize("name", GEOMS)
def test_power_iteration_close_to_reference(name):
    jp, tp, *_ = _problem(name)
    want = float(jfista_mod.power_iteration(jp))
    got = float(recon.power_iteration(tp, seed=0))
    assert abs(got / want - 1.0) < 0.03, (got, want)
    # seeded: the same generator state gives the same estimate
    assert float(recon.power_iteration(tp, seed=0)) == got


def test_tv_norm_and_prox_match_reference():
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 4)).astype(np.float32)
    assert _rel(recon.tv_norm(torch.from_numpy(x)),
                jrecon.tv_norm(jnp.asarray(x))) < 1e-6
    assert _rel(tfista_mod.tv_prox(torch.from_numpy(x), 0.1),
                jfista_mod.tv_prox(jnp.asarray(x), 0.1)) < 1e-6


@pytest.mark.parametrize("name", GEOMS)
def test_completion_matches_reference(name):
    jp, tp, f, y, mask = _problem(name)
    x_net = (f + np.random.default_rng(1).normal(
        scale=0.005, size=f.shape)).astype(np.float32)
    jx, jy, jm, jn = (jnp.asarray(a) for a in (x_net, y, mask, x_net))
    tx, ty, tm = (torch.from_numpy(a) for a in (x_net, y, mask))
    want_x, want_c = jrecon.complete_and_refine(jp, jx, jy, jm, n_iters=10)
    got_x, got_c = recon.complete_and_refine(tp, tx, ty, tm, n_iters=10)
    assert _rel(got_x, want_x) < IMG_TOL
    assert _rel(got_c, want_c) < IMG_TOL
    np.testing.assert_array_equal(got_c.numpy()[::2], y[::2])   # measured views
    ref_x = recon.data_consistency_refine(tp, tx, ty, tm, n_iters=10)
    torch.testing.assert_close(ref_x, got_x, rtol=0, atol=0)
    before = float(recon.projection_residual(tp, tx, ty, tm))
    assert abs(before - float(jrecon.projection_residual(jp, jn, jy, jm))) < 1e-5
    assert float(recon.projection_residual(tp, got_x, ty, tm)) < before


def test_helical_example_imports_only_the_port():
    path = ROOT / "examples" / "helical_recon_torch.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}
