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
from repro_torch.kernels import fp_cone, fp_fan, fp_par, precision, tune
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


# --------------------------------------------------------------------------- #
# What the kernels' launcher derives on the host (csrc/fp_fan.cu), held
# against the plain weights by brute force
# --------------------------------------------------------------------------- #
LAYOUT_GEOMS = {
    "flat": GEOMS["flat"],
    "curved": GEOMS["curved"],
    # a wide fan (half-angle ~34 degrees) at the axes and both sides of the
    # 45 and 135 degree group edges, flat and curved
    "edges_wide": (7, 1, 90, (40, 40, 1), dict(
        sod=48.0, sdd=96.0, pixel_width=1.0,
        angles=np.deg2rad([0.0, 44.0, 46.0, 90.0, 134.0, 136.0, 225.0]))),
    "edges_wide_curved": (7, 1, 90, (40, 40, 1), dict(
        sod=48.0, sdd=96.0, pixel_width=1.0, detector_type="curved",
        angles=np.deg2rad([0.0, 44.0, 46.0, 90.0, 134.0, 136.0, 225.0]))),
    "nx_ne_ny": (5, 1, 60, (20, 28, 1), dict(sod=100.0, sdd=180.0,
                                             pixel_width=0.4)),
}


def _taps(plan, grp):
    """(view, gi, li, u, t0, t3) of every tap of view group ``grp`` and
    whether its plain weight is nonzero, as flat arrays."""
    table = plan.on(torch.device("cpu")).tables[grp]
    ng, nl = plan.group(grp, 1)[:2]
    gi = torch.arange(ng, dtype=torch.float32)[None, :, None]
    li = torch.arange(nl, dtype=torch.float32)[None, None, :]
    t0, _, _, t3 = (t.reshape(table.shape[0], ng * nl) for t in
                    fp_cone._corner_trapezoid(table, gi, li, plan.sdd, plan.dxv,
                                              plan.curved)[:4])
    us, nz = [], []
    for u, w in plan.weights(table, ng, nl):
        us.append(u)
        nz.append(w != 0)
    return table, ng, nl, t0, t3, torch.stack(us, -1), torch.stack(nz, -1)


@pytest.mark.parametrize("name", list(LAYOUT_GEOMS))
def test_ku_bounds_the_columns_a_voxel_meets(name):
    """Every (voxel, view)'s columns that the kernels evaluate (those whose
    pixel meets its trapezoid, as the kernels' fan_column_window finds them)
    number at most FanPlan.ku, and every nonzero plain weight is among them:
    the window drops only exact zeros, and no voxel overflows its slots."""
    na, nv, nu, vs, kw = LAYOUT_GEOMS[name]
    plan = FanPlan(tgeo.fan_beam(na, nv, nu, tgeo.VolumeGeometry(*vs), **kw))
    el = torch.tensor([np.float32(np.float32(plan.e0) + np.float32(
        np.float32(u) * np.float32(plan.du))) for u in range(nu)])
    eh = el + plan.du
    most = 0
    for grp in (0, 1):
        _, _, _, t0, t3, u, nz = _taps(plan, grp)
        meets = (eh > t0[..., None]) & (el < t3[..., None])     # (a, vox, nu)
        most = max(most, int(meets.sum(-1).max()))
        hit = torch.gather(meets, 2, u)                           # (a, vox, taps)
        assert not (nz & ~hit).any(), "a nonzero weight outside the window"
    assert 1 <= most <= plan.ku(), (most, plan.ku())


@pytest.mark.parametrize("name", list(LAYOUT_GEOMS))
def test_tile_window_holds_every_nonzero_tap(name):
    """The FP kernel's voxel window of a tile and line (``tile_window``, the
    host's copy of the kernel's) holds the voxel of every nonzero plain
    weight of every column of the tile, at tiles of 1, 7 and 128 columns."""
    na, nv, nu, vs, kw = LAYOUT_GEOMS[name]
    plan = FanPlan(tgeo.fan_beam(na, nv, nu, tgeo.VolumeGeometry(*vs), **kw))
    for grp in (0, 1):
        table, ng, nl, _, _, u, nz = _taps(plan, grp)
        rows = table.numpy()
        a, vox, k = torch.nonzero(nz, as_tuple=True)
        cols = u[a, vox, k]
        for tu in (1, 7, 128):
            windows = {}
            for ai, vi, ui in zip(a.tolist(), vox.tolist(), cols.tolist()):
                gi, li, t = vi // nl, vi % nl, ui // tu
                key = (ai, li, t)
                if key not in windows:
                    windows[key] = fp_fan.tile_window(
                        plan, rows[ai], li, t * tu, min(t * tu + tu, nu) - 1, ng)
                g0, g1 = windows[key]
                assert g0 <= gi <= g1, (name, grp, tu, ai, gi, li, ui, g0, g1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", [tune.KernelConfig(), tune.KernelConfig(bu=1, lg=1),
                                 tune.KernelConfig(bu=7, bg=13, lg=3),
                                 tune.KernelConfig(bu=32, bg=32, lg=16)],
                         ids=lambda c: f"bu{c.bu}-bg{c.bg}-lg{c.lg}")
def test_fp_layout_fills_the_budget(cfg, dtype):
    """The FP layout takes the config's tile and lane chunk (8 lanes a
    thread, 16 from 4 groups on), the most voxel slots a piece within
    FP_SMEM_BUDGET that are a whole number a thread (one at least), and
    counts its shared memory as the kernel carves it (``_fp_smem``, held
    against the kernel's count on the card)."""
    _, tg = _pair("curved")
    plan = FanPlan(tg)
    elem = {torch.float32: 4, torch.bfloat16: 2}[dtype]
    for grp in (0, 1):
        lay = plan.fp_layout(grp, dtype, cfg)
        lpt = 16 if cfg.lg >= 4 and cfg.lg % 2 == 0 else 8
        assert (lay.tu, lay.lpt, lay.tl * lay.lpt) == (cfg.bu, lpt, 8 * cfg.lg)
        assert lay.nl == plan.group(grp, 1)[1] and lay.ku == plan.ku()
        count = lambda v: fp_fan._fp_smem(elem, lay.tu, 8 * cfg.lg, lay.nl, v,  # noqa: E731
                                          lay.segs, lay.ku)
        assert lay.smem == count(lay.vcap)
        nt = lay.tu * lay.tl
        if count(lay.vcap + 1) > fp_fan.fp_par.SMEM_MAX:
            continue                          # the card's most slots
        assert lay.vcap % nt == 0             # whole slots a thread
        assert lay.vcap == nt or lay.smem <= fp_fan.FP_SMEM_BUDGET
        assert count(lay.vcap + nt) > fp_fan.FP_SMEM_BUDGET
    bl = plan.bp_layout(cfg)
    assert (bl.bx * bl.by * bl.tl) % 32 == 0 and bl.ku == plan.ku()


def test_heuristic_config_shares_weights_across_lanes():
    """The fan heuristic: a lane chunk of as many groups of 8 lanes as the
    lanes need, up to 8 (weights shared by its threads), in blocks of 128
    threads."""
    v = tgeo.VolumeGeometry(16, 16, 1)
    g1 = tgeo.fan_beam(4, 1, 24, v, sod=40.0, sdd=80.0)
    assert tune.heuristic_config(g1, 8) == tune.KernelConfig(bu=128, bg=128, lg=1)
    assert tune.heuristic_config(g1, 3) == tune.KernelConfig(bu=128, bg=128, lg=1)
    g16 = tgeo.fan_beam(4, 16, 24, tgeo.VolumeGeometry(16, 16, 16), sod=40.0, sdd=80.0)
    assert tune.heuristic_config(g16, 4) == tune.KernelConfig(bu=32, bg=32, lg=8)
    g44 = tgeo.fan_beam(4, 44, 24, tgeo.VolumeGeometry(16, 16, 44), sod=40.0, sdd=80.0)
    assert tune.heuristic_config(g44, 3) == tune.KernelConfig(bu=32, bg=32, lg=8)


def test_layouts_hold_past_the_old_eight_bit_count():
    """A coarse volume over a fine detector (16 x 16 voxels of 6.25 mm over
    2048 columns of 0.1 mm): a voxel meets up to 314 columns, past the 254
    an 8-bit count held.  ``FanPlan.ku`` still bounds the columns every
    (voxel, view) meets, every nonzero plain weight is among them, and both
    layouts fit the card's shared memory (the BP's by fewer warps a block)."""
    g = tgeo.fan_beam(720, 1, 2048, tgeo.VolumeGeometry(16, 16, 1, dx=6.25,
                                                        dy=6.25),
                      sod=200.0, sdd=400.0, pixel_width=0.1)
    plan = FanPlan(g.subset([0, 89, 90, 91, 180, 269, 270, 271, 450]))
    assert plan.ku() == 314
    el = torch.tensor([np.float32(np.float32(plan.e0) + np.float32(
        np.float32(u) * np.float32(plan.du))) for u in range(g.n_cols)])
    eh = el + plan.du
    most = 0
    for grp in (0, 1):
        _, _, _, t0, t3, u, nz = _taps(plan, grp)
        meets = (eh > t0[..., None]) & (el < t3[..., None])
        most = max(most, int(meets.sum(-1).max()))
        assert not (nz & ~torch.gather(meets, 2, u)).any()
    assert 254 < most <= plan.ku(), most
    for batch in (1, 8):
        cfg = tune.heuristic_config(g, batch)
        for dtype in (torch.float32, torch.bfloat16):
            for grp in (0, 1):
                lay = plan.fp_layout(grp, dtype, cfg)
                assert lay.ku == plan.ku() and lay.smem <= fp_par.SMEM_MAX
        bl = plan.bp_layout(cfg)
        assert bl.ku == plan.ku() and bl.smem <= fp_par.SMEM_MAX
        assert (bl.bx * bl.by * bl.tl) % 32 == 0
        assert bl.smem == (fp_par._align16(8 * g.n_cols) + bl.bx * bl.by
                           * bl.tl * ((bl.ku | 1) + 1) * 4)
