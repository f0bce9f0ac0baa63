"""The port's SF footprint math against the reference's, on random and
degenerate trapezoids."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import footprint as jfp
from repro_torch.kernels import footprint as tfp


def _breakpoints(kind, rng, n=257):
    uc = rng.uniform(-20, 20, n).astype(np.float32)
    if kind == "random":
        hs = rng.uniform(0.5, 1.5, n).astype(np.float32)
        hd = (hs * rng.uniform(0, 1, n)).astype(np.float32)
    elif kind == "rectangle":                      # hs == hd
        hs = rng.uniform(0.5, 1.5, n).astype(np.float32)
        hd = hs.copy()
    else:                                          # triangle: hd == 0
        hs = rng.uniform(0.5, 1.5, n).astype(np.float32)
        hd = np.zeros(n, np.float32)
    h = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return [uc - hs, uc - hd, uc + hd, uc + hs, h]


@pytest.mark.parametrize("kind", ["random", "rectangle", "triangle"])
def test_trapezoid_cdf_and_pixel_weight(kind):
    rng = np.random.default_rng(0)
    t0, t1, t2, t3, h = _breakpoints(kind, rng)
    t = (t0 + rng.uniform(-2, 4, t0.shape)).astype(np.float32)
    el = (t0 + rng.uniform(-3, 3, t0.shape)).astype(np.float32)
    eh = (el + np.float32(1.1)).astype(np.float32)
    J = [jnp.asarray(a) for a in (t, el, eh, t0, t1, t2, t3, h)]
    T = [torch.from_numpy(a) for a in (t, el, eh, t0, t1, t2, t3, h)]
    np.testing.assert_allclose(tfp.trapezoid_cdf(T[0], *T[3:]).numpy(),
                               np.asarray(jfp.trapezoid_cdf(J[0], *J[3:])),
                               rtol=1e-6, atol=1e-6)
    w_t = tfp.trapezoid_pixel_weight(T[1], T[2], *T[3:]).numpy()
    w_j = np.asarray(jfp.trapezoid_pixel_weight(J[1], J[2], *J[3:]))
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-6)
    assert (w_t >= 0).all() and (w_t > 0).any()


def test_parallel_footprint_and_rect_overlap():
    rng = np.random.default_rng(1)
    uc = rng.uniform(-10, 10, 64).astype(np.float32)
    ang = rng.uniform(0, np.pi, 64).astype(np.float32)
    c, s = np.cos(ang), np.sin(ang)
    got = tfp.parallel_footprint(torch.from_numpy(uc), torch.from_numpy(c),
                                 torch.from_numpy(s), 1.25)
    want = jfp.parallel_footprint(jnp.asarray(uc), jnp.asarray(c),
                                  jnp.asarray(s), 1.25)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    lo = rng.uniform(-2, 2, 64).astype(np.float32)
    hi = lo + rng.uniform(0, 2, 64).astype(np.float32)
    el = rng.uniform(-2, 2, 64).astype(np.float32)
    eh = el + np.float32(0.8)
    np.testing.assert_allclose(
        tfp.rect_overlap(*map(torch.from_numpy, (lo, hi, el, eh))).numpy(),
        np.asarray(jfp.rect_overlap(*map(jnp.asarray, (lo, hi, el, eh)))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("curved", [False, True])
def test_divergent_footprint_matches_reference_and_tables(curved):
    """The world-space corner trapezoid equals the reference's, and the
    kernels' table form (fp_cone._corner_trapezoid) gives the same
    trapezoid for every voxel of a small fan geometry."""
    import repro_torch.core.geometry as tgeo
    from repro_torch.kernels import fp_cone
    rng = np.random.default_rng(2)
    x = rng.uniform(-20, 20, 64).astype(np.float32)
    y = rng.uniform(-20, 20, 64).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, 64).astype(np.float32)
    c, s = np.cos(ang), np.sin(ang)
    got = tfp.fan_transaxial_footprint(*map(torch.from_numpy, (x, y, c, s)),
                                       90.0, 170.0, 1.5, curved)
    want = jfp.fan_transaxial_footprint(*map(jnp.asarray, (x, y, c, s)),
                                        90.0, 170.0, 1.5, curved)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)
    g = tgeo.fan_beam(12, 1, 40, tgeo.VolumeGeometry(10, 10, 1, dx=1.5, dy=1.5),
                      sod=90.0, sdd=170.0, pixel_width=2.0,
                      detector_type="curved" if curved else "flat")
    px, py, order = fp_cone._view_params_cone(g)
    ang = g.angles_array()[order]
    X = torch.from_numpy(g.vol.x_coords())[:, None]
    Y = torch.from_numpy(g.vol.y_coords())[None, :]
    gi = torch.arange(10.0)[None, :, None]
    li = torch.arange(10.0)[None, None, :]
    w = fp_cone.footprint_halfwidth(g)
    for k, (table, gathered_x) in enumerate(((px, True), (py, False))):
        tab = fp_cone._corner_trapezoid(torch.from_numpy(table), gi, li,
                                        170.0, 1.5, curved)
        views = ang[:len(px)] if k == 0 else ang[len(px):]
        for a, th in enumerate(views):
            ref = tfp.fan_transaxial_footprint(
                X, Y, torch.tensor(np.cos(th)), torch.tensor(np.sin(th)),
                90.0, 170.0, 1.5, curved)
            for t_tab, t_ref in zip(tab[:5], ref[:5]):
                t_tab = t_tab[a] if gathered_x else t_tab[a].T
                np.testing.assert_allclose(t_tab.numpy(), t_ref.numpy(),
                                           rtol=1e-5, atol=1e-4)
            # every corner projects within the half-width bound of the centre
            uc = (170.0 * torch.atan2(Y * np.cos(th) - X * np.sin(th), ref[5])
                  if curved else 170.0 * (Y * np.cos(th) - X * np.sin(th)) / ref[5])
            assert float((uc - ref[0]).max()) <= w and float((ref[3] - uc).max()) <= w
