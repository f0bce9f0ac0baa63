"""The port's parallel SF pair (the CPU path of the kernel wrappers, and the
``ref`` backend) against the reference package: its plain oracle
``ref.forward``/``ref.adjoint`` and its Pallas kernels in interpret mode."""
import dataclasses

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


# --------------------------------------------------------------------------- #
# The CUDA kernels' layouts (derived on the host) against the plain weights
# --------------------------------------------------------------------------- #
_EDGE_ANGLES = np.deg2rad([0.0, 30.0, 44.0, 45.0, 46.0, 90.0, 134.0, 135.0,
                           136.0, 179.5])
LAYOUT_GEOMS = {
    # nx, ny, na, nu, volume kwargs, detector kwargs
    "ragged": (24, 24, 5, 40, {}, {}),
    "nx_ne_ny": (20, 28, 12, 44, {}, {}),
    "edges": (20, 20, None, 32, {}, {}),
    "offset_aniso": (20, 20, 8, 30,
                     dict(dx=1.5, dy=1.5, offset_x=1.3, offset_y=-0.8),
                     dict(pixel_width=1.1, center_col=0.4)),
    "fine_pixels": (16, 16, 7, 64, {}, dict(pixel_width=0.3)),
    "coarse_pixels": (16, 16, 9, 12, {}, dict(pixel_width=2.5)),
}
LAYOUT_CONFIGS = {"heuristic": None,
                  "pinned": fp_par.tune.KernelConfig(bu=8, bg=24, lg=2)}


def _layout_plan(name):
    nx, ny, na, nu, vk, dk = LAYOUT_GEOMS[name]
    vol = tgeo.VolumeGeometry(nx, ny, 1, **vk)
    if na is None:
        g = tgeo.parallel_beam(len(_EDGE_ANGLES), 1, nu, vol,
                               angles=_EDGE_ANGLES, **dk)
    else:
        g = tgeo.parallel_beam(na, 1, nu, vol, **dk)
    return ParallelPlan(g)


def _patterns(plan, grp):
    """Per view of group ``grp``: ``nz[gi, li, u]``, the plain version's
    nonzero weights, and ``win[gi, li, u]``, the kernels' exact windows (the
    (voxel, column) pairs with t0 < el + du and t3 > el, in the kernels'
    float32 roundings)."""
    f = np.float32
    ng, nl = plan.group(grp, 1)[:2]
    nu = plan.geom.n_cols
    table = torch.from_numpy(plan.tables[grp])
    gi = np.arange(ng, dtype=f)[:, None, None]
    li = np.arange(nl, dtype=f)[None, :, None]
    el = (f(plan.e0) + np.arange(nu, dtype=f) * f(plan.du))[None, None, :]
    eh = el + f(plan.du)
    for a in range(table.shape[0]):
        nz = np.zeros((ng, nl, nu), bool)
        for u, w in plan.weights(table[a:a + 1], ng, nl):
            u, w = u.reshape(ng, nl).numpy(), w.reshape(ng, nl).numpy()
            g_i, l_i = np.nonzero(w != 0)
            nz[g_i, l_i, u[g_i, l_i]] = True
        P, Q, R, hs = (f(v) for v in plan.tables[grp][a, :4])
        uc = (P * gi + Q * li) + R
        win = ((uc - hs) < eh) & ((uc + hs) > el)
        yield a, nz, win


@pytest.mark.parametrize("config", list(LAYOUT_CONFIGS))
@pytest.mark.parametrize("name", list(LAYOUT_GEOMS))
def test_fp_layout_bounds_hold_the_nonzero_pattern(name, config):
    """The FP kernel's layout (``ParallelPlan.fp_layout``) against the plain
    version's nonzero weights: every nonzero lies in the kernel's exact
    window; a (line, column) window holds at most ``kw`` voxels; and for
    every batch of views (``fp_batches``: neighbours, P of one sign), tile
    of ``tu`` columns and chunk of ``lch`` lines the windows lie in the
    staged window of ``_tile_window`` (the kernel's), which holds at most
    ``wcap`` rows."""
    plan = _layout_plan(name)
    cfg = LAYOUT_CONFIGS[config] or fp_par.tune.parallel_config(plan.geom, 3)
    nu = plan.geom.n_cols
    for grp in (0, 1):
        ng, nl = plan.group(grp, 1)[:2]
        lays = {plan.fp_layout(grp, dtype, cfg)
                for dtype in (torch.float32, torch.bfloat16)}
        lays |= {dataclasses.replace(lay, nvb=nvb, lch=lch,
                                     wcap=plan.fp_wcap(grp, lay.tu, lch, nvb))
                 for lay in list(lays) for nvb in (1, 3) for lch in (1, 4)}
        pats = {a: win for a, _, win in _patterns(plan, grp)}
        for a, nz, win in _patterns(plan, grp):
            assert not (nz & ~win).any(), "a nonzero outside the window"
            assert win.sum(axis=0).max() <= min(lay.kw for lay in lays)
        for lay in lays:
            assert lay.tu * 8 * cfg.lg == lay.tu * lay.tl * lay.lpt
            assert lay.smem <= fp_par.FP_SMEM_BUDGET or lay.lch == 1
            for batch in plan.fp_batches(grp, lay.nvb):
                views = batch[batch >= 0]
                assert len({bool(plan.tables[grp][v, 0] > 0) for v in views}) == 1
                for u0 in range(0, nu, lay.tu):
                    u1 = min(u0 + lay.tu, nu) - 1
                    for l0 in range(0, nl, lay.lch):
                        l1 = min(l0 + lay.lch, nl) - 1
                        used = np.zeros(ng, bool)
                        for v in views:
                            used |= pats[v][:, l0:l1 + 1, u0:u1 + 1].any(axis=(1, 2))
                        G0, G1 = fp_par._tile_window(plan.tables[grp][views],
                                                     plan.e0, plan.du, u0, u1,
                                                     l0, l1, ng)
                        assert G1 - G0 + 1 <= lay.wcap, (G0, G1, lay)
                        g_i = np.nonzero(used)[0]
                        if g_i.size:
                            assert G0 <= g_i.min() and g_i.max() <= G1, (views, u0, l0)


@pytest.mark.parametrize("name", list(LAYOUT_GEOMS))
def test_bp_layout_bounds_hold_the_nonzero_pattern(name):
    """The BP kernel's bound (``ParallelPlan.bp_layout``) against the plain
    version's nonzero weights: every nonzero lies in the kernel's exact
    column window, which holds at most ``ku`` columns."""
    plan = _layout_plan(name)
    lay = plan.bp_layout(fp_par.tune.parallel_config(plan.geom, 3))
    most = 0
    for grp in (0, 1):
        for _, nz, win in _patterns(plan, grp):
            assert not (nz & ~win).any(), "a nonzero outside the window"
            most = max(most, int(win.sum(axis=2).max()))
    assert 1 <= most <= lay.ku, (most, lay)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_padding_keeps_the_lanes(dtype):
    """The lane-packed wrappers' ``_aligned``, for the parallel and the fan
    pair alike (both read 16 bytes at a time, ``LANE_BYTES``): a tile whose
    lanes' bytes are a multiple of 16 at an aligned address is passed as
    it is; a ragged lane axis, or a tile at an address that is not a
    multiple of 16, becomes a fresh aligned copy whose lane axis is padded
    by zeros to a multiple of 16 bytes."""
    par = ParallelPlan(tgeo.parallel_beam(4, 1, 8, tgeo.VolumeGeometry(4, 4, 1)))
    fan = FanPlan(tgeo.fan_beam(4, 1, 8, tgeo.VolumeGeometry(4, 4, 1), sod=40.0,
                                sdd=80.0))
    vn = 16 // torch.tensor([], dtype=dtype).element_size()
    for plan in (par, fan):
        x = torch.randn(4, 4, 2 * vn).to(dtype)
        assert fp_par._aligned(x, plan) is x
        for lanes, offset in ((3, 0), (vn + 1, 0), (vn, 1), (2 * vn, 1)):
            base = torch.randn(4 * 4 * lanes + offset).to(dtype)
            y = base[offset:].view(4, 4, lanes)
            got = fp_par._aligned(y, plan)
            assert got.data_ptr() % 16 == 0 and got.is_contiguous()
            assert got.shape[-1] == -(-lanes // vn) * vn
            assert torch.equal(got[..., :lanes], y)
            assert not got[..., lanes:].any()


def test_layouts_follow_the_config():
    """The parallel heuristic's lane chunk stops at 16 groups of 8 lanes,
    its FP tile is 32 columns at 8 lanes and 16 beyond, its BP block 128
    threads; the BP block is whole warps of a power-of-two lane split; a
    pinned config is taken as given, one too large for shared memory
    refused; the fan pair's launch arguments are its own."""
    tune = fp_par.tune
    vol = tgeo.VolumeGeometry(64, 64, 64)
    g = tgeo.parallel_beam(12, 64, 96, vol)
    assert tune.parallel_config(g, 1) == tune.KernelConfig(bu=16, bg=32, lg=8)
    assert tune.parallel_config(g, 8) == tune.KernelConfig(bu=16, bg=16, lg=16)
    g2 = tgeo.parallel_beam(12, 1, 96, tgeo.VolumeGeometry(64, 64, 1))
    assert tune.parallel_config(g2, 8) == tune.KernelConfig(bu=32, bg=128, lg=1)
    assert tune.parallel_config(g2, 3) == tune.KernelConfig(bu=32, bg=128, lg=1)
    assert tune.parallel_config(g2, 12) == tune.KernelConfig(bu=16, bg=64, lg=2)
    plan = ParallelPlan(g)
    for cfg, want in ((tune.KernelConfig(bu=8, bg=24, lg=3), (4, 4, 2)),
                      (tune.KernelConfig(bu=8, bg=13, lg=2), (4, 4, 2)),
                      (tune.KernelConfig(bu=8, bg=256, lg=1), (16, 16, 1)),
                      (tune.KernelConfig(bu=8, bg=16, lg=64), (4, 4, 32))):
        lay = plan.bp_layout(cfg)
        assert (lay.bx, lay.by, lay.tl) == want, (cfg, lay)
        assert (lay.bx * lay.by * lay.tl) % 32 == 0
    lay = plan.fp_layout(0, torch.float32, tune.KernelConfig(bu=24, lg=3))
    assert (lay.tu, lay.tl, lay.lpt) == (24, 3, 8)
    lay = plan.fp_layout(0, torch.float32, tune.KernelConfig(bu=24, lg=8))
    assert (lay.tu, lay.tl, lay.lpt) == (24, 4, 16)
    # fewer threads than the block's 8 view slots a view (the kernel fills
    # them in a strided loop)
    lay = plan.fp_layout(0, torch.float32, tune.KernelConfig(bu=1, lg=1))
    assert (lay.tu, lay.tl, lay.lpt, lay.nvb) == (1, 1, 8, fp_par.FP_VIEWS)
    # the staged window is clamped to the gathered axis: a wide one needs
    # a wide volume
    wide = ParallelPlan(tgeo.parallel_beam(4, 1, 64,
                                           tgeo.VolumeGeometry(4096, 4096, 1),
                                           pixel_width=8.0))
    with pytest.raises(ValueError, match="shared memory"):
        wide.fp_layout(0, torch.float32, tune.KernelConfig(bu=512, lg=2))
    fan = FanPlan(tgeo.fan_beam(4, 2, 12, tgeo.VolumeGeometry(8, 8, 2), sod=40.0,
                                sdd=80.0, pixel_width=2.0))
    cfg = tune.KernelConfig(bu=16, bg=32, lg=2)
    x = torch.zeros(8, 8, 4)
    fl, bl = fan.fp_layout(0, x.dtype, cfg), fan.bp_layout(cfg)
    head = (fan.sdd, fan.dxv, fan.hw, int(fan.curved))
    assert fan.fp_tail(0, x, cfg) == (*head, 16, 2, 8, fl.vcap, fl.segs, fl.ku)
    assert fan.bp_tail(0, x, cfg, 1) == (fan.sdd, fan.dxv, int(fan.curved), 1,
                                         bl.bx, bl.by, 2, 8, bl.ku)
    assert (bl.bx * bl.by, bl.tl) == (32, 2)


WIDE = {
    # a coarse volume over a fine detector: 455 columns a voxel and view
    "bp_455": lambda: tgeo.parallel_beam(
        90, 1, 512, tgeo.VolumeGeometry(64, 64, 1, dx=16.0, dy=16.0),
        pixel_width=0.05),
    # a fine volume over a coarse detector: 421 voxels a column and line
    "fp_421": lambda: tgeo.parallel_beam(
        90, 1, 16, tgeo.VolumeGeometry(512, 512, 1, dx=0.02, dy=0.02),
        pixel_width=6.0),
}


@pytest.mark.parametrize("name", list(WIDE))
def test_layouts_hold_past_the_old_eight_bit_counts(name):
    """Past the 254 an 8-bit count held, the bounds still hold the plain
    version's nonzero weights (``fp_kw`` a line and column, ``bp_ku`` a
    voxel and view), the staged window stays within the gathered axis, and
    both layouts fit the card's shared memory (the BP's by fewer warps a
    block)."""
    g = WIDE[name]()
    plan = ParallelPlan(g.subset([0, 11, 22, 23, 34, 45, 56, 67, 68, 80]))
    cfg = fp_par.tune.parallel_config(g, 8)
    bl = plan.bp_layout(cfg)
    assert bl.smem <= fp_par.SMEM_MAX and (bl.bx * bl.by * bl.tl) % 32 == 0
    assert bl.smem == bl.bx * bl.by * bl.tl * ((bl.ku | 1) + 1) * 4
    kws = []
    for grp in (0, 1):
        ng = plan.group(grp, 1)[0]
        for dtype in (torch.float32, torch.bfloat16):
            lay = plan.fp_layout(grp, dtype, cfg)
            assert lay.smem <= fp_par.SMEM_MAX and lay.wcap <= ng
            kws.append(lay.kw)
        for _, nz, win in _patterns(plan, grp):
            assert not (nz & ~win).any(), "a nonzero outside the window"
            assert win.sum(axis=2).max() <= bl.ku
            assert win.sum(axis=0).max() <= min(kws)
    assert max(min(kws), bl.ku) > 254
