"""The CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; they skip elsewhere.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import (Projector, ProjectorSpec, VolumeGeometry, cone_beam,
                         fan_beam, helical_beam, modular_beam, parallel_beam)
from repro_torch import kernels as K
from repro_torch.core.geometry import cone_as_modular
from repro_torch.device import requires_cuda
from repro_torch.kernels import (flash, fp_cone, fp_fan, fp_modular, fp_par,
                                 precision, tune)
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.kernels.fp_cone import ConePlan
from repro_torch.kernels.fp_fan import FanPlan
from repro_torch.kernels.fp_modular import ModularPlan
from repro_torch.kernels.fp_par import ParallelPlan

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    """The port's tune cache in this test's own directory: a configuration
    measured by one test (or found in the user's cache) changes no other
    test's kernels."""
    monkeypatch.setenv(tune.CACHE_PATH_ENV, str(tmp_path / "tune.json"))

SHAPES = [
    (16, 16, 4, 6, 4, 24, 1),      # nx, ny, nz, na, nv, nu, batch
    (24, 24, 2, 5, 2, 40, 3),      # ragged lanes (6) and columns
    (64, 64, 1, 90, 1, 96, 8),     # the 2D training shape, cut down
    (16, 16, 1, 8, 44, 24, 3),     # 132 lanes: a chunk of 128 and a ragged one
    (20, 28, 1, 12, 2, 300, 3),    # nx != ny; 300 columns: ragged column tiles
    (64, 64, 1, 30, 1, 600, 2),    # 600 columns: many tiles, batches of views
]
# views at the axes and on both sides of 45 and 135 degrees, where the
# view groups meet and the windows are tightest
EDGE_ANGLES = np.deg2rad([0.0, 44.0, 45.0, 46.0, 90.0, 134.0, 135.0, 136.0,
                          179.5])


def _par_match_plain(g, batch, dtype, cfg=None):
    """Both parallel kernels against their plain versions on random tiles;
    ``cfg`` None: the parallel heuristic."""
    plan = ParallelPlan(g)
    dt = getattr(torch, dtype)
    cfg = cfg or tune.parallel_config(g, batch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lanes = batch * g.n_rows
    vol = torch.randn((g.vol.nx, g.vol.ny, lanes), generator=gen, device="cuda").to(dt)
    sino = torch.randn((g.n_angles, g.n_cols, lanes), generator=gen,
                       device="cuda").to(dt)
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    fp_par.reset_launches()
    for run, plain, x in ((fp_par.fp_lanes, fp_par.fp_lanes_plain, vol),
                          (fp_par.bp_lanes, fp_par.bp_lanes_plain, sino)):
        got = run(x, plan, cfg)
        torch.cuda.synchronize()
        want = plain(x, plan)
        assert bool(torch.isfinite(got).all())
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel
    assert fp_par.LAUNCHES["fp_par_sf"] >= 1 and fp_par.LAUNCHES["bp_par_sf"] >= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(shape, dtype):
    requires_cuda()
    nx, ny, nz, na, nv, nu, batch = shape
    _par_match_plain(parallel_beam(na, nv, nu, VolumeGeometry(nx, ny, nz)), batch,
                     dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pixel_width", [1.0, 0.3])
def test_kernels_match_plain_at_the_view_group_edges(pixel_width, dtype):
    requires_cuda()
    g = parallel_beam(len(EDGE_ANGLES), 4, int(40 / pixel_width),
                      VolumeGeometry(24, 24, 4), angles=EDGE_ANGLES,
                      pixel_width=pixel_width)
    _par_match_plain(g, 3, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [tune.KernelConfig(bu=24, bg=40, lg=2),
                                 tune.KernelConfig(bu=7, bg=13, lg=3),
                                 tune.KernelConfig(bu=32, bg=32, lg=16),
                                 # FP blocks of 4 and 16 threads: fewer than
                                 # the block's 8 view-table slots a view
                                 tune.KernelConfig(bu=1, bg=32, lg=1),
                                 tune.KernelConfig(bu=4, bg=32, lg=1)],
                         ids=lambda c: f"bu{c.bu}-bg{c.bg}-lg{c.lg}")
def test_kernels_match_plain_with_a_pinned_config(cfg, dtype):
    requires_cuda()
    _par_match_plain(parallel_beam(11, 44, 50, VolumeGeometry(24, 20, 44)), 3,
                     dtype, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_take_tiles_at_any_address(dtype):
    """A tile at an address that is not a multiple of 16 bytes (a view one
    element into its storage) is copied to aligned memory by the wrapper
    and gives the aligned tile's result; the C launch refuses such a tile
    itself."""
    requires_cuda()
    from repro_torch.kernels import build
    g = parallel_beam(10, 2, 30, VolumeGeometry(20, 20, 2))
    plan, cfg = ParallelPlan(g), tune.parallel_config(g, 4)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for run, shape in ((fp_par.fp_lanes, (20, 20, 8)),
                       (fp_par.bp_lanes, (10, 30, 8))):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        base = torch.zeros(x.numel() + 1, dtype=dt, device="cuda")
        y = base[1:].view(shape)
        y.copy_(x)
        assert y.data_ptr() % 16 != 0
        assert torch.equal(run(y, plan, cfg), run(x, plan, cfg))
    lib = build.library("fp_par")
    dtab = plan.on(x.device)
    out = torch.empty((20, 20, 8), device="cuda")
    rc = lib.bp_par_sf_launch(
        fp_par._DTYPE_CODE[dt], dtab.tables[0].data_ptr(), dtab.rows[0].data_ptr(),
        dtab.tables[0].shape[0], y.data_ptr(), out.data_ptr(),
        *plan.group(0, 8)[:2], 8, *plan.group(0, 8)[2:], g.n_cols, plan.e0,
        plan.du, *plan.bp_tail(0, x, cfg, 0),
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_exceeded_bounds_write_nan(monkeypatch):
    """A window past the host's bound (here: bounds cut to 1) writes NaN:
    a dropped nonzero cannot pass the kernel-vs-plain check."""
    requires_cuda()
    g = parallel_beam(6, 2, 24, VolumeGeometry(16, 16, 2))
    plan = ParallelPlan(g)
    cfg = tune.parallel_config(g, 2)
    vol = torch.ones((16, 16, 4), device="cuda")
    sino = torch.ones((6, 24, 4), device="cuda")
    assert bool(torch.isfinite(fp_par.fp_lanes(vol, plan, cfg)).all())
    monkeypatch.setattr(ParallelPlan, "fp_kw", lambda self, grp: 1)
    monkeypatch.setattr(ParallelPlan, "bp_ku", lambda self: 1)
    assert bool(torch.isnan(fp_par.fp_lanes(vol, plan, cfg)).any())
    assert bool(torch.isnan(fp_par.bp_lanes(sino, plan, cfg)).any())
    monkeypatch.undo()
    monkeypatch.setattr(ParallelPlan, "fp_wcap", lambda self, grp, tu, lch, nvb: 2)
    assert bool(torch.isnan(fp_par.fp_lanes(vol, plan, cfg)).any())


def test_parallel_instances_fit_the_card():
    """Every parallel kernel instance fits the card at the main and 512^3
    cells' layouts and at pinned ones: blocks per SM from the card, at
    least one, and the FP's shared memory as the kernel counts it equal to
    the host's count (``fp_info`` raises otherwise)."""
    requires_cuda()
    cfgs = [None, tune.KernelConfig(bu=1, bg=32, lg=1),
            tune.KernelConfig(bu=7, bg=13, lg=3),
            tune.KernelConfig(bu=32, bg=32, lg=16)]
    for lanes, n_rows in ((8, 1), (512, 512)):
        g = parallel_beam(4, n_rows, 768, VolumeGeometry(512, 512, n_rows))
        plan = ParallelPlan(g)
        for dt in (torch.float32, torch.bfloat16):
            for cfg in cfgs:
                cfg = cfg or tune.parallel_config(g, lanes // n_rows)
                fl = plan.fp_layout(0, dt, cfg)
                info = fp_par.fp_info(fl, dt)
                assert info["smem_bytes"] == fl.smem
                assert info["blocks_per_sm"] >= 1, (fl, dt)
                bl = plan.bp_layout(cfg)
                assert fp_par.bp_info(bl, dt)["blocks_per_sm"] >= 1, (bl, dt)


@pytest.mark.parametrize("shape", [(10, 6, 36, (24, 24, 6), None),
                                   (10, 44, 36, (24, 20, 44), 3)],
                         ids=["rows6", "rows44-batch3"])
def test_kernel_pair_dot_test_and_gradient(shape):
    """The dot test and the autograd gradient through the kernels; the
    second case has 132 lanes, more than one lane chunk."""
    requires_cuda()
    na, nv, nu, vs, batch = shape
    g = parallel_beam(na, nv, nu, VolumeGeometry(*vs))
    proj = Projector(ProjectorSpec(g, backend="cuda"))
    rng = np.random.default_rng(0)
    lead = () if batch is None else (batch,)
    x = torch.from_numpy(rng.normal(size=lead + g.vol.shape).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=lead + g.sino_shape).astype(np.float32)).cuda()
    fp_par.reset_launches()
    lhs = float((proj(x).double() * y.double()).sum())
    rhs = float((x.double() * proj.T(y).double()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - y) ** 2), xg)
    torch.testing.assert_close(grad, proj.T(proj(x) - y), rtol=1e-4, atol=1e-5)
    assert fp_par.LAUNCHES["fp_par_sf"] >= 1 and fp_par.LAUNCHES["bp_par_sf"] >= 1


# views at the axes and on both sides of 45, 135, 225 and 315 degrees: the
# view groups' edges, where the fan FP's tile windows are tightest
FAN_EDGE_ANGLES = np.deg2rad([0.0, 44.0, 45.0, 46.0, 90.0, 134.0, 135.0, 136.0,
                              179.5, 224.0, 226.0, 314.0, 316.0])

DIVERGENT = [
    # kind, n_angles, n_rows, n_cols, (nx, ny, nz), kwargs, batch
    ("fan", 12, 2, 40, (24, 24, 2), dict(sod=80.0, sdd=160.0, pixel_width=2.0), 3),
    ("fan", 12, 1, 96, (48, 48, 1), dict(sod=200.0, sdd=220.0, pixel_width=1.0,
                                         detector_type="curved"), 8),
    # 132 lanes: a chunk of 128 and a ragged one; 36 columns
    ("fan", 9, 44, 36, (24, 24, 44), dict(sod=80.0, sdd=160.0, pixel_width=2.0), 3),
    # nx != ny; 300 columns, not a multiple of the 128-column tile
    ("fan", 10, 1, 300, (20, 28, 1), dict(sod=100.0, sdd=180.0, pixel_width=0.4), 3),
    ("fan", len(FAN_EDGE_ANGLES), 1, 70, (24, 24, 1),
     dict(sod=60.0, sdd=120.0, pixel_width=1.0, angles=FAN_EDGE_ANGLES), 2),
    # a wide fan (half-angle ~34 degrees) on the curved detector, 2 rows
    ("fan", len(FAN_EDGE_ANGLES), 2, 200, (48, 48, 2),
     dict(sod=60.0, sdd=120.0, pixel_width=1.0, angles=FAN_EDGE_ANGLES,
          detector_type="curved"), 2),
    ("cone", 9, 16, 36, (24, 24, 12), dict(sod=80.0, sdd=160.0, pixel_width=2.0,
                                           pixel_height=2.0), 2),
    ("cone", 6, 20, 40, (32, 32, 24), dict(sod=60.0, sdd=150.0, pixel_width=2.0,
                                           pixel_height=1.5), 1),
]


def _divergent(case):
    kind, na, nv, nu, vs, kw, batch = case
    make = fan_beam if kind == "fan" else cone_beam
    return make(na, nv, nu, VolumeGeometry(*vs), **kw), batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DIVERGENT, ids=lambda c: f"{c[0]}-{c[3]}")
def test_divergent_kernels_match_plain(case, dtype):
    requires_cuda()
    g, batch = _divergent(case)
    cfg = tune.heuristic_config(g, batch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    if g.geom_type == "fan":
        plan, mod = FanPlan(g), fp_fan
        args = (plan, cfg)
        lanes = batch * g.n_rows
        vol = torch.randn((g.vol.nx, g.vol.ny, lanes), generator=gen, device="cuda")
        sino = torch.randn((g.n_angles, g.n_cols, lanes), generator=gen, device="cuda")
        pairs = ((fp_fan.fp_lanes, fp_fan.fp_lanes_plain, vol),
                 (fp_fan.bp_lanes, fp_fan.bp_lanes_plain, sino))
    else:
        plan, mod = ConePlan(g), fp_cone
        args = (plan,)                    # the cone launch takes no config
        vol = torch.randn((batch,) + g.vol.shape, generator=gen, device="cuda")
        sino = torch.randn((batch,) + g.sino_shape, generator=gen, device="cuda")
        pairs = ((fp_cone.fp_batch, fp_cone.fp_batch_plain, vol),
                 (fp_cone.bp_batch, fp_cone.bp_batch_plain, sino))
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    mod.reset_launches()
    for run, plain, x in pairs:
        x = x.to(dt)
        got = run(x, *args)
        torch.cuda.synchronize()
        want = plain(x, plan)
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel
    assert all(n >= 1 for n in mod.LAUNCHES.values()), mod.LAUNCHES


@pytest.mark.parametrize("case", DIVERGENT, ids=lambda c: f"{c[0]}-{c[3]}")
def test_divergent_pair_dot_test_and_gradient(case):
    requires_cuda()
    g, batch = _divergent(case)
    proj = Projector(ProjectorSpec(g, backend="cuda"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(batch,) + g.vol.shape).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=(batch,) + g.sino_shape).astype(np.float32)).cuda()
    lhs = float((proj(x).double() * y.double()).sum())
    rhs = float((x.double() * proj.T(y).double()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - y) ** 2), xg)
    torch.testing.assert_close(grad, proj.T(proj(x) - y), rtol=1e-4, atol=1e-5)


def _fan_match_plain(g, batch, dtype, cfg=None):
    """Both fan kernels against their plain versions on random tiles;
    ``cfg`` None: the fan heuristic."""
    plan = FanPlan(g)
    dt = getattr(torch, dtype)
    cfg = cfg or tune.heuristic_config(g, batch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lanes = batch * g.n_rows
    vol = torch.randn((g.vol.nx, g.vol.ny, lanes), generator=gen, device="cuda").to(dt)
    sino = torch.randn((g.n_angles, g.n_cols, lanes), generator=gen,
                       device="cuda").to(dt)
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    fp_fan.reset_launches()
    for run, plain, x in ((fp_fan.fp_lanes, fp_fan.fp_lanes_plain, vol),
                          (fp_fan.bp_lanes, fp_fan.bp_lanes_plain, sino)):
        got = run(x, plan, cfg)
        torch.cuda.synchronize()
        want = plain(x, plan)
        assert bool(torch.isfinite(got).all())
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel
    assert fp_fan.LAUNCHES["fp_fan_sf"] >= 1 and fp_fan.LAUNCHES["bp_fan_sf"] >= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("det", ["flat", "curved"])
@pytest.mark.parametrize("cfg", [tune.KernelConfig(bu=1, bg=32, lg=1),
                                 tune.KernelConfig(bu=4, bg=32, lg=1),
                                 tune.KernelConfig(bu=7, bg=13, lg=3),
                                 tune.KernelConfig(bu=24, bg=40, lg=2),
                                 tune.KernelConfig(bu=32, bg=32, lg=16)],
                         ids=lambda c: f"bu{c.bu}-bg{c.bg}-lg{c.lg}")
def test_fan_kernels_match_plain_with_a_pinned_config(cfg, det, dtype):
    """Pinned fan layouts, down to FP tiles of one and four columns, on 132
    ragged lanes over nx != ny."""
    requires_cuda()
    _fan_match_plain(fan_beam(11, 44, 50, VolumeGeometry(24, 20, 44), sod=80.0,
                              sdd=160.0, pixel_width=1.0, detector_type=det),
                     3, dtype, cfg)


def test_fan_exceeded_bound_writes_nan(monkeypatch):
    """A voxel meeting more columns than the host's bound (here: cut to 1)
    writes NaN in both kernels: a dropped nonzero cannot pass the
    kernel-vs-plain check."""
    requires_cuda()
    g = fan_beam(6, 2, 24, VolumeGeometry(16, 16, 2), sod=40.0, sdd=80.0)
    plan = FanPlan(g)
    cfg = tune.heuristic_config(g, 2)
    vol = torch.ones((16, 16, 4), device="cuda")
    sino = torch.ones((6, 24, 4), device="cuda")
    assert bool(torch.isfinite(fp_fan.fp_lanes(vol, plan, cfg)).all())
    assert bool(torch.isfinite(fp_fan.bp_lanes(sino, plan, cfg)).all())
    monkeypatch.setattr(FanPlan, "ku", lambda self: 1)
    assert bool(torch.isnan(fp_fan.fp_lanes(vol, plan, cfg)).any())
    assert bool(torch.isnan(fp_fan.bp_lanes(sino, plan, cfg)).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fan_kernels_take_tiles_at_any_address(dtype):
    """A fan tile at an address that is not a multiple of 16 bytes is
    copied to aligned memory by the wrapper and gives the aligned tile's
    result; the C launch refuses such a tile itself."""
    requires_cuda()
    from repro_torch.kernels import build
    g = fan_beam(10, 2, 30, VolumeGeometry(20, 20, 2), sod=60.0, sdd=120.0)
    plan, cfg = FanPlan(g), tune.heuristic_config(g, 4)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for run, shape in ((fp_fan.fp_lanes, (20, 20, 8)), (fp_fan.bp_lanes, (10, 30, 8))):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        base = torch.zeros(x.numel() + 1, dtype=dt, device="cuda")
        y = base[1:].view(shape)
        y.copy_(x)
        assert y.data_ptr() % 16 != 0
        assert torch.equal(run(y, plan, cfg), run(x, plan, cfg))
    lib = build.library("fp_fan")
    dtab = plan.on(x.device)
    out = torch.empty((20, 20, 8), device="cuda")
    rc = lib.bp_fan_sf_launch(
        fp_par._DTYPE_CODE[dt], dtab.tables[0].data_ptr(), dtab.rows[0].data_ptr(),
        dtab.tables[0].shape[0], y.data_ptr(), out.data_ptr(),
        *plan.group(0, 8)[:2], 8, *plan.group(0, 8)[2:], g.n_cols, plan.e0,
        plan.du, *plan.bp_tail(0, x, cfg, 0), torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_fan_instances_fit_the_card():
    """Every fan kernel instance fits the card at the fan cells' layouts
    (8 and 64 lanes, flat and curved) and at pinned ones: blocks per SM
    from the card, at least one, and the FP's shared memory as the kernel
    counts it equal to the host's count (``fp_info`` raises otherwise)."""
    requires_cuda()
    cfgs = [None, tune.KernelConfig(bu=1, bg=32, lg=1),
            tune.KernelConfig(bu=7, bg=13, lg=3),
            tune.KernelConfig(bu=32, bg=32, lg=16)]
    for n_rows, batch in ((1, 8), (16, 4)):
        for det in ("flat", "curved"):
            g = fan_beam(4, n_rows, 1126, VolumeGeometry(512, 512, n_rows),
                         sod=1024.0, sdd=1536.0, detector_type=det)
            plan = FanPlan(g)
            for dt in (torch.float32, torch.bfloat16):
                for cfg in cfgs:
                    cfg = cfg or tune.heuristic_config(g, batch)
                    fl = plan.fp_layout(0, dt, cfg)
                    info = fp_fan.fp_info(fl, dt, plan.curved)
                    assert info["smem_bytes"] == fl.smem
                    assert info["blocks_per_sm"] >= 1, (fl, dt)
                    bl = plan.bp_layout(cfg)
                    assert fp_fan.bp_info(bl, dt, plan.curved, g.n_cols)[
                        "blocks_per_sm"] >= 1, (bl, dt)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fan_division_rounds_as_ieee(seed):
    """The fan kernels' division by a reciprocal and two corrections
    (``fan_div_rn``) gives __fdiv_rn's bits on 2^24 pairs over the divisors
    the weights take, zero and tiny overlaps included."""
    requires_cuda()
    assert fp_fan.division_mismatches(seed, 1 << 24) == 0


def _wobbly(na=9, nv=12, nu=32, seed=3):
    """tests/test_modular.py:38-57 on a 24 x 24 x 12 volume: per-view sod,
    sdd, source height and detector shifts, e_v flipped on odd views."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, na))
    sod = 80.0 + rng.uniform(-5, 5, na)
    sdd = 160.0 + rng.uniform(-10, 10, na)
    zsrc = rng.uniform(-4, 4, na)
    c, s = np.cos(ang), np.sin(ang)
    src = np.stack([sod * c, sod * s, zsrc], -1)
    eu = np.stack([-s, c, np.zeros(na)], -1)
    ev = np.stack([np.zeros(na), np.zeros(na),
                   np.where(np.arange(na) % 2 == 0, 1.0, -1.0)], -1)
    ctr = (np.stack([(sod - sdd) * c, (sod - sdd) * s, zsrc], -1)
           + rng.uniform(-3, 3, na)[:, None] * eu
           + rng.uniform(-3, 3, na)[:, None] * ev)
    return modular_beam(src, ctr, eu, ev, nv, nu, VolumeGeometry(24, 24, 12),
                        pixel_width=2.0, pixel_height=2.0)


MODULAR = {
    # name: (geometry, batch); batch 1 and batch > 1 run different instances
    "helical": (helical_beam(2.0, 4.0, 24, 6, 40, VolumeGeometry(24, 24, 8),
                             sod=48.0, sdd=72.0, pixel_height=2.0), 8),
    "tall": (helical_beam(1.0, 16.0, 6, 6, 24, VolumeGeometry(16, 16, 24),
                          sod=80.0, sdd=120.0, pixel_width=2.0,
                          pixel_height=1.0), 1),
    "wobbly": (_wobbly(), 3),
    "cone_as_modular": (cone_as_modular(cone_beam(
        9, 16, 36, VolumeGeometry(24, 24, 12), sod=80.0, sdd=160.0,
        pixel_width=2.0, pixel_height=2.0)), 1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODULAR)
def test_modular_kernels_match_plain(name, dtype):
    requires_cuda()
    g, batch = MODULAR[name]
    plan = ModularPlan(g)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    vol = torch.randn((batch,) + g.vol.shape, generator=gen, device="cuda")
    sino = torch.randn((batch,) + g.sino_shape, generator=gen, device="cuda")
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    fp_modular.reset_launches()
    for run, plain, x in ((fp_modular.fp_batch, fp_modular.fp_batch_plain, vol),
                          (fp_modular.bp_batch, fp_modular.bp_batch_plain, sino)):
        x = x.to(dt)
        got = run(x, plan)
        torch.cuda.synchronize()
        want = plain(x, plan)
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel
    assert all(n >= 1 for n in fp_modular.LAUNCHES.values()), fp_modular.LAUNCHES


def test_modular_pair_matches_cone_kernels_and_is_matched():
    """cone_as_modular through the Projector on the card: the modular
    kernels reproduce the cone kernels, launch, and pass the dot test and
    the gradient check."""
    requires_cuda()
    gc = cone_beam(9, 16, 36, VolumeGeometry(24, 24, 12), sod=80.0, sdd=160.0,
                   pixel_width=2.0, pixel_height=2.0)
    pm = Projector(ProjectorSpec(cone_as_modular(gc), backend="cuda"))
    pc = Projector(ProjectorSpec(gc, backend="cuda"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2,) + gc.vol.shape).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.normal(size=(2,) + gc.sino_shape).astype(np.float32)).cuda()
    K.reset_launches()
    ax, aty = pm(x), pm.T(y)
    assert K.launches()["fp_modular_sf"] >= 1 and K.launches()["bp_modular_sf"] >= 1
    for got, want in ((ax, pc(x)), (aty, pc.T(y))):
        assert float((got - want).norm() / want.norm()) < 1e-4
    lhs = float((ax.double() * y.double()).sum())
    rhs = float((x.double() * aty.double()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((pm(xg) - y) ** 2), xg)
    assert torch.equal(grad, pm.T(pm(x) - y))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("spt", [1, 8])
@pytest.mark.parametrize("family", ["cone", "modular"])
def test_cone_family_instances_match_plain(family, spt, batch):
    """Both instances of the cone-family kernels (one and eight samples per
    thread) at a batch of one and of three, whichever the wrappers would
    pick, against the plain versions."""
    requires_cuda()
    gc = cone_beam(9, 16, 36, VolumeGeometry(24, 24, 12), sod=80.0, sdd=160.0,
                   pixel_width=2.0, pixel_height=2.0)
    g, plan, lib = ((gc, ConePlan(gc), "fp_cone") if family == "cone" else
                    (_wobbly(), ModularPlan(_wobbly()), "fp_modular"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    vol = torch.randn((batch,) + g.vol.shape, generator=gen, device="cuda")
    sino = torch.randn((batch,) + g.sino_shape, generator=gen, device="cuda")
    tally = {f"fp_{family}_sf": 0, f"bp_{family}_sf": 0}
    for kname, plain, x in ((f"fp_{family}_sf", fp_cone.fp_batch_plain, vol),
                            (f"bp_{family}_sf", fp_cone.bp_batch_plain, sino)):
        got = fp_cone.launch(lib, kname, x, plan, tally, spt=spt)
        torch.cuda.synchronize()
        want = plain(x, plan)
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= 2e-4, rel
    assert all(n >= 1 for n in tally.values()), tally


def _fp_tile_cases():
    """The FP's tile traps, small (name: family, geometry): a cone whose
    detector spans 3 x 3 tiles of 32 x 32, both ragged (75 columns, 70
    rows), at views 0, 44, 45, 46, 134, 135 and 136 degrees (the view-group
    edges); a cone whose detector reaches past the pole of the gather map
    (|u| = sdd tan 45 = 40 mm on a 200 mm detector), where a window is the
    whole line; the wobbly frames (signed magnification) and a helical scan
    (a moving source, 6 rows in one tile)."""
    return {
        "tiles_edges": ("cone", cone_beam(
            360, 70, 75, VolumeGeometry(20, 20, 30), sod=60.0, sdd=120.0,
            pixel_width=1.0, pixel_height=1.0).subset([0, 44, 45, 46, 134, 135, 136])),
        "pole": ("cone", cone_beam(
            8, 6, 200, VolumeGeometry(16, 16, 6), sod=30.0, sdd=40.0,
            pixel_width=1.0, pixel_height=2.0)),
        "wobbly": ("modular", _wobbly()),
        "helical": ("modular", MODULAR["helical"][0]),
    }


def _fp_family(family, g):
    plan = ConePlan(g) if family == "cone" else ModularPlan(g)
    return plan, f"fp_{family}", f"fp_{family}_sf"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("name", ["tiles_edges", "pole", "wobbly", "helical"])
def test_fp_tiles_match_plain_and_both_instances(name, batch, dtype):
    """The cone-family FP on ragged tiles, at the view-group edges and the
    pole of the gather map, under signed magnification and a moving
    source, at batch 1, 3 and 9 (ragged against the 8 samples a block): both
    instances against the plain version (2e-4 in f32, BF16_KERNEL_REL_TOL
    in bf16) and bit-equal to each other; in f32 the dot test against the
    BP (< 1e-4)."""
    requires_cuda()
    family, g = _fp_tile_cases()[name]
    plan, lib, kname = _fp_family(family, g)
    gen = torch.Generator(device="cuda").manual_seed(batch)
    dt = getattr(torch, dtype)
    x = torch.randn((batch,) + g.vol.shape, generator=gen, device="cuda").to(dt)
    tally = {kname: 0, f"bp_{family}_sf": 0}
    got = {spt: fp_cone.launch(lib, kname, x, plan, tally, spt=spt) for spt in (1, 8)}
    torch.cuda.synchronize()
    want = fp_cone.fp_batch_plain(x, plan)
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    for spt, out in got.items():
        assert bool(torch.isfinite(out).all()), spt
        assert _rel(out, want) <= tol, (spt, _rel(out, want))
    assert torch.equal(got[1], got[8])
    if dtype == "float32":
        y = torch.randn((batch,) + g.sino_shape, generator=gen, device="cuda")
        aty = fp_cone.launch(lib, f"bp_{family}_sf", y, plan, tally)
        lhs = float((got[8].double() * y.double()).sum())
        rhs = float((x.double() * aty.double()).sum())
        assert abs(lhs - rhs) / abs(lhs) < 1e-4
    assert tally[kname] >= 2


@pytest.mark.parametrize("name", ["tiles_edges", "pole", "helical"])
def test_fp_passes_give_the_same_sums(name, monkeypatch):
    """Buffers of three survivors and one voxel's slices a pass: every
    window is walked in many passes, which must give the default layout's
    output bit for bit."""
    requires_cuda()
    family, g = _fp_tile_cases()[name]
    plan, lib, kname = _fp_family(family, g)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((3,) + g.vol.shape, generator=gen, device="cuda")
    tally = {kname: 0}
    want = fp_cone.launch(lib, kname, x, plan, tally)
    layout = fp_cone.fp_layout

    def tiny(plan, spt):
        lay, nz = layout(plan, spt), plan.geom.vol.nz
        words = fp_cone._fp_smem_words(lay.tv, lay.ncap, 3, nz, spt)
        return dataclasses.replace(lay, smax=3, emax=nz, smem_bytes=4 * words)

    monkeypatch.setattr(fp_cone, "fp_layout", tiny)
    got = fp_cone.launch(lib, kname, x, plan, tally)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["tiles_edges", "pole", "wobbly", "helical"])
def test_fp_shared_memory_count_is_the_kernels(name):
    """The host's count of the FP's shared memory (``fp_layout``) is the
    one the kernel carves (``fp_info`` raises otherwise), and the blocks
    per SM the host planned for (``FP_BLOCKS``) fit on the card, for both
    instances and dtypes."""
    requires_cuda()
    family, g = _fp_tile_cases()[name]
    plan, lib, _ = _fp_family(family, g)
    for spt in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            info = fp_cone.fp_info(lib, plan, dtype, spt)
            assert info["smem_bytes"] == fp_cone.fp_layout(plan, spt).smem_bytes
            assert info["blocks_per_sm"] >= fp_cone.FP_BLOCKS[spt], info


@pytest.mark.parametrize("dv", [2.0, 1.5, 0.388, 0.625, 0.139, 2.0 ** -20,
                                2.0 ** 20])
def test_fp_division_rounds_as_ieee(dv):
    """The cone-family FP divides each overlap by the row pitch as
    ``sf_div_rn`` (a product and two corrections): over every float overlap
    with a normal quotient it gives ``__fdiv_rn``'s bits, at power-of-two,
    published and extreme pitches."""
    requires_cuda()
    assert fp_cone.division_mismatches(dv) == 0


@pytest.mark.parametrize("name", ["tiles_edges", "helical"])
def test_fp_phase_build_gives_the_same_sums(name):
    """The FP built with its phase profile (``build.VARIANTS["phases"]``)
    gives the bits of the FP the port runs, and counts at least one pass."""
    requires_cuda()
    import ctypes
    from repro_torch.kernels import build
    family, g = _fp_tile_cases()[name]
    plan, lib, kname = _fp_family(family, g)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((3,) + g.vol.shape, generator=gen, device="cuda")
    tally = {kname: 0}
    want = fp_cone.launch(lib, kname, x, plan, tally)
    got = fp_cone.launch(lib, kname, x, plan, tally, variant="phases")
    sums = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    read = getattr(build.library(lib, "phases"), f"{lib}_phases_read")
    assert read(sums) == 0 and sums[4] >= 1
    assert torch.equal(got, want)


def _bp_cases():
    """The BP's traps: the FP's tile cases, and a cone of 0.25 mm rows, of
    which one slice meets up to 11 (more than the ``BP_ROWS`` axial weights
    a slice keeps in registers), so that it runs the body that forms each
    axial weight in its column loop."""
    cases = _fp_tile_cases()
    cases["fine_rows"] = ("cone", cone_beam(
        5, 40, 30, VolumeGeometry(12, 12, 10), sod=60.0, sdd=120.0,
        pixel_width=1.0, pixel_height=0.25))
    return cases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 9])
@pytest.mark.parametrize("name", ["tiles_edges", "pole", "wobbly", "helical",
                                  "fine_rows"])
def test_bp_tiles_match_plain_and_both_instances(name, batch, dtype):
    """The cone-family BP at the view-group edges, on ragged warps of
    gathered voxels, at the pole of the gather map, under signed
    magnification, a moving source and fine rows, at batch 1, 3 and 9
    (ragged against the 8 samples a thread): both instances against the
    plain version (2e-4 in f32, BF16_KERNEL_REL_TOL in bf16) and bit-equal
    to each other; in f32 the dot test against the FP (< 1e-4)."""
    requires_cuda()
    family, g = _bp_cases()[name]
    plan, lib, fname = _fp_family(family, g)
    kname = f"bp_{family}_sf"
    assert fp_cone.bp_layout(plan).cached == (name != "fine_rows")
    gen = torch.Generator(device="cuda").manual_seed(batch)
    dt = getattr(torch, dtype)
    y = torch.randn((batch,) + g.sino_shape, generator=gen, device="cuda").to(dt)
    tally = {kname: 0, fname: 0}
    got = {spt: fp_cone.launch(lib, kname, y, plan, tally, spt=spt) for spt in (1, 8)}
    torch.cuda.synchronize()
    want = fp_cone.bp_batch_plain(y, plan)
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    for spt, out in got.items():
        assert bool(torch.isfinite(out).all()), spt
        assert _rel(out, want) <= tol, (spt, _rel(out, want))
    assert torch.equal(got[1], got[8])
    if dtype == "float32":
        x = torch.randn((batch,) + g.vol.shape, generator=gen, device="cuda")
        ax = fp_cone.launch(lib, fname, x, plan, tally)
        lhs = float((ax.double() * y.double()).sum())
        rhs = float((x.double() * got[8].double()).sum())
        assert abs(lhs - rhs) / abs(lhs) < 1e-4
    assert tally[kname] >= 2


@pytest.mark.parametrize("name", ["tiles_edges", "pole", "helical"])
def test_bp_paths_give_the_same_sums(name, monkeypatch):
    """A row bound above ``BP_ROWS`` runs the body that forms each axial
    weight in its column loop instead of once a view: the same terms in the
    same order, so the default body's output bit for bit."""
    requires_cuda()
    family, g = _bp_cases()[name]
    plan, lib, _ = _fp_family(family, g)
    kname = f"bp_{family}_sf"
    gen = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn((3,) + g.sino_shape, generator=gen, device="cuda")
    tally = {kname: 0}
    want = fp_cone.launch(lib, kname, y, plan, tally)
    layout = fp_cone.bp_layout
    monkeypatch.setattr(fp_cone, "bp_layout", lambda plan: dataclasses.replace(
        layout(plan), rows=fp_cone.BP_ROWS + 1))
    got = fp_cone.launch(lib, kname, y, plan, tally)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_bp_exceeded_row_bound_writes_nan(monkeypatch):
    """A row bound that the host guaranteed but a slice exceeds (here a
    false bound of ``BP_ROWS`` on 0.25 mm rows) writes NaN to the voxels
    concerned, never a truncated sum."""
    requires_cuda()
    _, g = _bp_cases()["fine_rows"]
    plan = ConePlan(g)
    y = torch.ones((1,) + g.sino_shape, device="cuda")
    layout = fp_cone.bp_layout
    monkeypatch.setattr(fp_cone, "bp_layout", lambda plan: dataclasses.replace(
        layout(plan), rows=fp_cone.BP_ROWS))
    got = fp_cone.launch("fp_cone", "bp_cone_sf", y, plan, {"bp_cone_sf": 0})
    torch.cuda.synchronize()
    assert bool(torch.isnan(got).any())


@pytest.mark.parametrize("name", ["tiles_edges", "helical"])
def test_bp_phase_build_gives_the_same_sums(name):
    """The BP built with its phase profile (``build.VARIANTS["phases"]``)
    gives the bits of the BP the port runs, and counts its thread-views."""
    requires_cuda()
    import ctypes
    from repro_torch.kernels import build
    family, g = _bp_cases()[name]
    plan, lib, _ = _fp_family(family, g)
    kname = f"bp_{family}_sf"
    gen = torch.Generator(device="cuda").manual_seed(13)
    y = torch.randn((3,) + g.sino_shape, generator=gen, device="cuda")
    tally = {kname: 0}
    want = fp_cone.launch(lib, kname, y, plan, tally)
    read = getattr(build.library(lib, "phases"), f"{lib}_phases_read")
    sums = (ctypes.c_ulonglong * 8)()
    assert read(sums) == 0                                 # zero the sums
    got = fp_cone.launch(lib, kname, y, plan, tally, variant="phases")
    torch.cuda.synchronize()
    assert read(sums) == 0 and sums[4] >= 1
    assert torch.equal(got, want)


def test_bp_instances_fit_the_card():
    """Each of the eight BP instances keeps the blocks of 128 threads an SM
    that its launch bounds ask for (``BP_BLOCKS``)."""
    requires_cuda()
    for lib in ("fp_cone", "fp_modular"):
        for spt in (1, 8):
            for dtype in (torch.float32, torch.bfloat16):
                info = fp_cone.bp_info(lib, dtype, spt)
                assert info["blocks_per_sm"] >= fp_cone.BP_BLOCKS[spt], (lib, spt, info)


FLASH = {
    # name: (B, H, KV, S, hd, window)
    "gqa2_hd64": (1, 4, 2, 256, 64, None),
    "qwen3_heads": (2, 16, 8, 512, 128, None),
    "g8_window": (1, 32, 4, 384, 64, 100),      # TinyLlama's G = 8
    "ragged_window": (1, 4, 2, 200, 128, 64),   # S not a multiple of 64
    # 32 kv tiles for the last q tile, 2 x 32 (head, q tile) stages for the
    # first kv tile: the bf16 backward's two-stage copy ring wraps many times
    "long_ring": (1, 16, 8, 2048, 128, None),
    # Nemotron-4 340B's head dim and G = 12; ragged, with a window
    "hd192": (1, 24, 2, 512, 192, None),
    "hd192_ragged_window": (1, 12, 1, 200, 192, 64),
    # at hd 192, 32 kv tiles for the last q tile and 12 x 32 (head, q tile)
    # stages for the first kv tile: the two-warpgroup backward's ring wraps
    # many times
    "hd192_long_ring": (1, 24, 2, 2048, 192, None),
    # the model's (B, S, H, hd) activations, handed over as strided views
    "hd192_model_layout": (2, 24, 2, 384, 192, None),
    # the hd-192 forward's 128-row blocks: the last block's second consumer
    # has no row inside S (its Q tile arrives as zeros), and S shorter than
    # one tile
    "hd192_last_block_half": (1, 12, 1, 320, 192, None),
    "hd192_short": (1, 12, 1, 40, 192, None),
}
# cells whose tensors are (B, S, heads, hd) transposed to (B, heads, S, hd)
MODEL_LAYOUT = ("hd192_model_layout",)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FLASH)
def test_flash_kernels_match_plain(name, dtype):
    """Rows 9-12 element by element against their plain versions: the
    forward (with lse) against the plain forward at the kernels' tile, dq
    and dk/dv against flash_bwd_plain on the kernels' lse and delta; the
    autograd Function's gradients are those wrappers' outputs.  The
    MODEL_LAYOUT cells hand the kernels transposed (B, S, heads, hd)
    tensors, as the model does."""
    requires_cuda()
    B, H, KV, S, hd, window = FLASH[name]
    dt = getattr(torch, dtype)
    tol, f32 = flash.KERNEL_TOL[dt], flash.KERNEL_TOL[torch.float32]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(n):
        if name in MODEL_LAYOUT:
            x = torch.randn((B, S, n, hd), generator=gen, device="cuda").transpose(1, 2)
            assert not x.is_contiguous()
        else:
            x = torch.randn((B, n, S, hd), generator=gen, device="cuda")
        return x.to(dt)
    q, k, v, do = (rand(n) for n in (H, KV, KV, H))
    flash.reset_launches()
    want, want_lse = flash.flash_attention_plain(
        q, k, v, window, chunk=flash.KERNEL_TILE, return_lse=True)
    assert flash.kernel_mismatch(flash.flash_attention(q, k, v, window), want, *tol) <= 1
    o, lse = flash.flash_fwd_with_stats(q, k, v, window)
    assert o.dtype == dt and lse.shape == (B, KV, H // KV, S)
    assert flash.kernel_mismatch(o, want, *tol) <= 1
    assert flash.kernel_mismatch(lse, want_lse, *f32) <= 1
    delta = flash.flash_delta(o, do)
    got = (flash.flash_bwd_dq(q, k, v, do, lse, delta, window),
           *flash.flash_bwd_dkv(q, k, v, do, lse, delta, window))
    ref = flash.flash_bwd_plain(q, k, v, do, lse, delta, window)
    for g, r in zip(got, ref):
        worst = flash.kernel_mismatch(g, r, *tol)
        assert g.dtype == dt and worst <= 1, (worst, tol)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad((flash.flash_attention_diff(*args, window) * do).sum(), args)
    torch.cuda.synchronize()
    for g, r in zip(grads, got):
        assert torch.equal(g, r)
    assert flash.LAUNCHES == {"flash_fwd": 1, "flash_fwd_stats": 2,
                              "flash_bwd_dq": 2, "flash_bwd_dkv": 2}


@pytest.mark.parametrize("kname", flash.KERNELS)
def test_flash_shared_memory_count_is_the_kernels(kname):
    """Every instance asks for the shared memory the host counts
    (flash.smem_bytes; kernel_info raises otherwise) and fits on an SM."""
    requires_cuda()
    for dt in (torch.float32, torch.bfloat16):
        for hd in flash.KERNEL_HEAD_DIMS:
            info = flash.kernel_info(kname, dt, hd)
            assert info["smem_bytes"] == flash.smem_bytes(kname, dt, hd)
            assert info["blocks_per_sm"] >= 1, (dt, hd, info)


def test_flash_refuses_what_it_has_no_kernel_for():
    requires_cuda()
    q = torch.zeros((1, 2, 64, 32), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_attention(q, q[:, :1], q[:, :1])
    q = torch.zeros((1, 2, 64, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash.flash_attention(q, q[:, :1], q[:, :1])


def test_long_prefill_and_gradient_run_the_kernels():
    """The model's long branch (S = 3072) on the card: prefill launches the
    forward kernel once per layer, a gradient the forward with statistics
    twice per layer (remat "full", the config's default, runs each layer
    again in the backward) and the two backward kernels once per layer,
    and both agree with the plain attention."""
    requires_cuda()
    cfg = ModelConfig(name="small", family="dense", n_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256,
                      vocab_size=512, qk_norm=True, compute_dtype="float32")
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, 512, (1, 3072), device="cuda")
    K.reset_launches()
    lg = make_prefill_step(cfg)(params, {"tokens": toks})
    assert K.launches()["flash_fwd"] == 2
    assert _rel(lg, make_prefill_step(cfg, backend="ref")(params, {"tokens": toks})) <= 1e-4
    leaves = [t.requires_grad_() for _, t in model._leaves(params)]
    K.reset_launches()
    got = torch.autograd.grad(model.loss_fn(cfg, params, {"tokens": toks}), leaves)
    n = K.launches()
    assert cfg.remat_policy == "full"
    assert n["flash_fwd_stats"] == 4 and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == 2, n
    want = torch.autograd.grad(
        model.loss_fn(cfg, params, {"tokens": toks}, backend="ref"), leaves)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


def test_long_branch_at_hd192_runs_the_kernels():
    """A dense config at Nemotron-4 340B's head dim 192 (d_model 768 over 4
    heads, no head_dim, as its 18432 / 96): the long branch (S = 3072)
    launches the forward kernel once per layer in prefill, and in a
    gradient the forward with statistics twice per layer (remat "full")
    and the two backward kernels once per layer; both agree with
    backend="ref"."""
    requires_cuda()
    cfg = ModelConfig(name="hd192", family="dense", n_layers=2, d_model=768,
                      n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
                      compute_dtype="float32")
    assert cfg.resolved_head_dim == 192 and flash.has_kernel(192)
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, 512, (1, 3072), device="cuda")
    K.reset_launches()
    lg = make_prefill_step(cfg)(params, {"tokens": toks})
    assert K.launches()["flash_fwd"] == 2
    assert _rel(lg, make_prefill_step(cfg, backend="ref")(params, {"tokens": toks})) <= 1e-4
    leaves = [t.requires_grad_() for _, t in model._leaves(params)]
    K.reset_launches()
    got = torch.autograd.grad(model.loss_fn(cfg, params, {"tokens": toks}), leaves)
    n = K.launches()
    assert n["flash_fwd_stats"] == 4 and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == 2, n
    want = torch.autograd.grad(
        model.loss_fn(cfg, params, {"tokens": toks}, backend="ref"), leaves)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


def test_hybrid_long_branch_matches_plain_attention():
    """A Hymba-shaped hybrid (5 query heads over 1 kv head of 64, window
    2048, layers 0 and 2 global, 1 windowed; the Mamba block beside each
    attention) at S = 4096 in f32: the prefill launches the forward kernel
    once a layer, the gradient the forward with statistics twice a layer
    (remat "full") and the two backward kernels once; both agree with
    backend="ref"."""
    requires_cuda()
    from repro_torch.models.config import SSMConfig
    cfg = ModelConfig(name="hybrid", family="hybrid", n_layers=3, d_model=320,
                      n_heads=5, n_kv_heads=1, head_dim=64, d_ff=256, vocab_size=512,
                      ssm=SSMConfig(d_state=16), sliding_window=2048,
                      global_attn_every=2, compute_dtype="float32")
    assert model._layer_windows(cfg).tolist() == [True, False, True]
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, 512, (1, 4096), device="cuda")
    K.reset_launches()
    lg = make_prefill_step(cfg)(params, {"tokens": toks})
    assert K.launches()["flash_fwd"] == 3
    assert _rel(lg, make_prefill_step(cfg, backend="ref")(params, {"tokens": toks})) <= 1e-4
    leaves = [t.requires_grad_() for _, t in model._leaves(params)]
    K.reset_launches()
    got = torch.autograd.grad(model.loss_fn(cfg, params, {"tokens": toks}), leaves)
    n = K.launches()
    assert n["flash_fwd_stats"] == 6 and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == 3, n
    want = torch.autograd.grad(
        model.loss_fn(cfg, params, {"tokens": toks}, backend="ref"), leaves)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


def _update_rel(p, p_ref, p0):
    """``||d - d_ref|| / ||d_ref||`` of the parameter changes ``d = p - p0``
    and ``d_ref = p_ref - p0`` of one leaf (``err``, ``ref``: the squared
    norms, to sum over leaves)."""
    d, d_ref = (p.double() - p0.double()), (p_ref.double() - p0.double())
    return float(((d - d_ref) ** 2).sum()), float((d_ref ** 2).sum())


LM_UPDATE_REL_TOL, LM_UPDATE_LEAF_REL_TOL = 0.15, 0.3


def test_lm_train_step_matches_plain_attention():
    """One training step (make_train_step: two microbatches of 2 x 4096,
    AdamW, clipping) of Qwen3-0.6B's widths at 2 layers on the card against
    the same step with backend="ref" (the plain attention): its loss and
    gradients within 5e-2 of each leaf's largest entry, chip_smoke.py's
    LM_GRAD_REL_TOL for the bf16 model; the parameters' change from their
    start against the plain step's change, ||d - d_ref|| / ||d_ref|| at
    most LM_UPDATE_REL_TOL over all leaves and LM_UPDATE_LEAF_REL_TOL on
    each, every d_ref nonzero (AdamW's first step moves each entry by
    about lr * sign(g), so the two differ where bf16 flips the sign of a
    gradient entry near zero); the kernels launched as remat "full" says."""
    requires_cuda()
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.launch.train import build
    cfg = dataclasses.replace(configs.get("qwen3-0.6b"), n_layers=2, grad_accum=2)
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    p0 = {k: v.clone() for k, v in model.flatten(params).items()}
    toks = torch.randint(0, cfg.vocab_size, (4, 4096), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    out = {}
    for backend in ("auto", "ref"):
        grads = {}

        def capture(g):
            grads.update(g)
            return g

        opt, _ = build(cfg, None, total_steps=8)
        K.reset_launches()
        p, _, m = steps.make_train_step(cfg, opt, compress_fn=capture, backend=backend)(
            params, opt.init(model.flatten(params)), {"tokens": toks})
        out[backend] = (float(m["loss"]), grads, model.flatten(p), K.launches())
    loss, grads, p, n = out["auto"]
    assert n["flash_fwd_stats"] == 8 and n["flash_bwd_dq"] == n["flash_bwd_dkv"] == 4, n
    assert not any(out["ref"][3].values())
    assert abs(loss / out["ref"][0] - 1) <= 5e-2
    num = den = 0.0
    for k, g in grads.items():
        assert _rel(g, out["ref"][1][k]) <= 5e-2, k
        err, ref = _update_rel(p[k], out["ref"][2][k], p0[k])
        assert ref > 0, (k, "the plain step did not move")
        assert (err / ref) ** 0.5 <= LM_UPDATE_LEAF_REL_TOL, (k, (err / ref) ** 0.5)
        num, den = num + err, den + ref
    assert (num / den) ** 0.5 <= LM_UPDATE_REL_TOL, (num / den) ** 0.5


def test_long_branch_without_kernels_refuses_on_the_card():
    """A dense config whose head dim has no kernel (96: d_model 768 over 8
    heads, no head_dim; no config of the port has it): on the card the long
    branch (S = 3072) raises NotImplementedError naming the built head
    dims, before any flash launch, for the forward and the gradient;
    backend="ref" runs it, and the dense branch (S = 2048) runs on "auto"
    and gives what backend="ref" gives."""
    requires_cuda()
    cfg = ModelConfig(name="hd96", family="dense", n_layers=2, d_model=768,
                      n_heads=8, n_kv_heads=2, d_ff=256, vocab_size=512,
                      compute_dtype="float32")
    assert cfg.resolved_head_dim == 96 and not flash.has_kernel(96)
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, 512, (1, 3072), device="cuda")
    K.reset_launches()
    with pytest.raises(NotImplementedError, match="head dims"):
        make_prefill_step(cfg)(params, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="head dims"):
        model.loss_fn(cfg, params, {"tokens": toks})
    assert all(K.launches()[k] == 0 for k in flash.LAUNCHES), K.launches()
    lg = make_prefill_step(cfg, backend="ref")(params, {"tokens": toks})
    assert bool(torch.isfinite(lg).all())
    short = toks[:, :2048]
    got = make_prefill_step(cfg)(params, {"tokens": short})
    assert _rel(got, make_prefill_step(cfg, backend="ref")(params, {"tokens": short})) <= 1e-4


# --------------------------------------------------------------------------- #
# The lane-packed kernels past the old 8-bit counts
# --------------------------------------------------------------------------- #
LANE_CAPS = {
    # a fan voxel meeting 314 columns
    "fan_314": lambda: fan_beam(720, 1, 2048, VolumeGeometry(16, 16, 1, dx=6.25,
                                                            dy=6.25),
                                sod=200.0, sdd=400.0, pixel_width=0.1),
    # a parallel voxel meeting 455 columns
    "par_bp_455": lambda: parallel_beam(90, 1, 512, VolumeGeometry(
        64, 64, 1, dx=16.0, dy=16.0), pixel_width=0.05),
    # a parallel column and line meeting 421 voxels
    "par_fp_421": lambda: parallel_beam(90, 1, 16, VolumeGeometry(
        512, 512, 1, dx=0.02, dy=0.02), pixel_width=6.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LANE_CAPS))
def test_lane_caps_match_plain(name, dtype):
    requires_cuda()
    g = LANE_CAPS[name]()
    if g.geom_type == "parallel":
        _par_match_plain(g, 8, dtype)
        return
    plan, cfg = FanPlan(g), tune.heuristic_config(g, 8)
    assert plan.ku() > 254
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    for run, plain, shape in ((fp_fan.fp_lanes, fp_fan.fp_lanes_plain,
                               (g.vol.nx, g.vol.ny, 8)),
                              (fp_fan.bp_lanes, fp_fan.bp_lanes_plain,
                               (g.n_angles, g.n_cols, 8))):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        got = run(x, plan, cfg)
        want = plain(x, plan)
        assert bool(torch.isfinite(got).all())
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel


# --------------------------------------------------------------------------- #
# The packed cone pair: the fan kernels on a cone geometry's lanes
# --------------------------------------------------------------------------- #
def _packed_geom(sod=256.0):
    return cone_beam(24, 8, 96, VolumeGeometry(64, 64, 8, dx=0.4, dy=0.4, dz=0.4),
                     sod=sod, sdd=1.5 * sod, pixel_width=0.6, pixel_height=0.6)


@pytest.mark.parametrize("cfg", [None, tune.KernelConfig(bu=16, bg=32, lg=2),
                                 tune.KernelConfig(bu=1, bg=32, lg=1)],
                         ids=["heuristic", "bu16_lg2", "bu1"])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_pair_matches_plain(dtype, batch, cfg):
    """The packed pair (fp_fan_sf / bp_fan_sf on a ConePackedPlan) on CUDA
    tensors (the fan kernels, and only they, launch) against the plain
    composition on the same plan."""
    requires_cuda()
    g = _packed_geom()
    plan = fp_fan.ConePackedPlan(g)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lead = () if batch is None else (batch,)
    dt = getattr(torch, dtype)
    x = torch.randn(lead + g.vol.shape, generator=gen, device="cuda")
    y = torch.randn(lead + g.sino_shape, generator=gen, device="cuda")
    tol = 2e-4 if dtype == "float32" else precision.BF16_KERNEL_REL_TOL
    K.reset_launches()
    got_fp = fp_fan.fp_fan_sf(x, plan, config=cfg, compute_dtype=dt)
    got_bp = fp_fan.bp_fan_sf(y, plan, config=cfg, compute_dtype=dt)
    launches = K.launches()
    assert launches["fp_fan_sf"] >= 1 and launches["bp_fan_sf"] >= 1
    assert launches["fp_cone_sf"] == 0 and launches["bp_cone_sf"] == 0
    want_fp = fp_par.fp_packed(x, plan, dt, lambda t: fp_par.fp_lanes_plain(t, plan))
    want_bp = fp_par.bp_packed(y, plan, dt, lambda t: fp_par.bp_lanes_plain(t, plan))
    for got, want in ((got_fp, want_fp), (got_bp, want_bp)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel


def test_packed_pair_through_the_projector():
    """``mode="auto"`` resolves the packed pair on a geometry under the gate:
    dot test, gradient = backprojection, the fan kernels launch and the cone
    kernels do not; ``mode="exact"`` launches the cone kernels."""
    requires_cuda()
    from repro_torch import resolve_mode
    g = _packed_geom(1024.0)
    assert resolve_mode(g) == "packed"
    proj = Projector(ProjectorSpec(g))
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand((2,) + g.vol.shape, generator=gen, device="cuda")
    y = torch.randn((2,) + g.sino_shape, generator=gen, device="cuda")
    K.reset_launches()
    lhs = float(torch.sum(proj(x).double() * y.double()))
    rhs = float(torch.sum(x.double() * proj.T(y).double()))
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - y) ** 2), xg)
    torch.testing.assert_close(grad, proj.T(proj(x) - y), rtol=1e-4, atol=1e-5)
    launches = K.launches()
    assert launches["fp_fan_sf"] >= 1 and launches["fp_cone_sf"] == 0
    exact = Projector(ProjectorSpec(g, mode="exact"))
    err = float((proj(x) - exact(x)).norm() / exact(x).norm())
    assert err <= fp_cone.cone_packed_error_bound(g)
    assert K.launches()["fp_cone_sf"] >= 1


# --------------------------------------------------------------------------- #
# The Joseph projectors on card tensors (plain torch, no kernel)
# --------------------------------------------------------------------------- #
def _tilted_arcs():
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    src = np.stack([60 * np.cos(ang), 60 * np.sin(ang), 1.8 * np.sin(2 * ang)], -1)
    eu = np.stack([-np.sin(ang), np.cos(ang), np.zeros_like(ang)], -1)
    ev = np.cross(src / np.linalg.norm(src, axis=1, keepdims=True), eu)
    return modular_beam(src, -src, eu, ev, n_rows=8, n_cols=20,
                        vol=VolumeGeometry(12, 12, 6), pixel_width=2.0,
                        pixel_height=2.0)


JOSEPH = {
    "parallel": ("joseph", lambda: parallel_beam(10, 5, 20, VolumeGeometry(12, 14, 4),
                                                 pixel_width=1.3, pixel_height=1.1)),
    "cone_flat": ("joseph", lambda: cone_beam(10, 6, 24, VolumeGeometry(12, 14, 4),
                                              sod=80.0, sdd=160.0, pixel_width=1.5,
                                              pixel_height=1.5)),
    "cone_curved": ("joseph", lambda: cone_beam(
        10, 6, 24, VolumeGeometry(12, 14, 4), sod=80.0, sdd=160.0, pixel_width=1.5,
        pixel_height=1.5, detector_type="curved")),
    "modular_tilted_sf": ("sf", _tilted_arcs),
}


@pytest.mark.parametrize("name", list(JOSEPH))
def test_joseph_on_card_tensors(name):
    requires_cuda()
    from repro_torch.kernels import ref
    model, make = JOSEPH[name]
    g = make()
    proj = Projector(ProjectorSpec(g, model=model))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2,) + g.vol.shape, generator=gen)
    y = torch.randn((2,) + g.sino_shape, generator=gen)
    K.reset_launches()
    ax, aty = proj(x.cuda()), proj.T(y.cuda())
    assert ax.device.type == "cuda" and aty.device.type == "cuda"
    assert not any(K.launches().values())
    lhs = float(torch.sum(ax.double().cpu() * y.double()))
    rhs = float(torch.sum(x.double() * aty.double().cpu()))
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    torch.testing.assert_close(ax.cpu(), ref.forward(x, g, model), rtol=2e-4,
                               atol=2e-4 * float(ax.abs().max()))
    torch.testing.assert_close(aty.cpu(), ref.adjoint(y, g, model), rtol=2e-4,
                               atol=2e-4 * float(aty.abs().max()))
    with pytest.raises(NotImplementedError):
        Projector(ProjectorSpec(g, model=model, backend="cuda"))(x.cuda())


# --------------------------------------------------------------------------- #
# CT training on the card
# --------------------------------------------------------------------------- #
TRAIN_KERNELS = {"limited_angle": ("fp_par_sf", "bp_par_sf"),
                 "sparse_fan": ("fp_fan_sf", "bp_fan_sf"),
                 "helical": ("fp_modular_sf", "bp_modular_sf")}


def _tiny_train(geometry, **kw):
    """tests/test_ct_train.py's tiny() sizes; helical at its smoke size."""
    from repro_torch.launch.ct_train import TrainConfig
    base = dict(geometry=geometry, n=12, steps=3, batch=2, base=8, levels=1,
                depth=1, warmup=1, ema_warmup=2, refine_iters=5,
                model="unet" if geometry != "limited_angle" else "auto")
    if geometry == "helical":
        base.update(n=20, nz=4)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("geometry", list(TRAIN_KERNELS))
def test_ct_trainer_step_kernels_match_plain(geometry):
    """One CTTrainer step's loss (rel 1e-5) and gradients (relative L2 1e-4)
    with the kernel pair against the plain pair on the card."""
    requires_cuda()
    from repro_torch.launch.ct_train import CTTrainer
    cfg = _tiny_train(geometry)
    kern, plain = CTTrainer(cfg), CTTrainer(cfg)
    plain.proj = Projector(ProjectorSpec(plain.geom, backend="ref",
                                         compute_dtype=cfg.compute_dtype),
                           plain.device)
    batch = kern.data(0)
    K.reset_launches()
    lk, gk = kern.grad_fn(kern.params, *batch)
    assert all(K.launches()[k] > 0 for k in TRAIN_KERNELS[geometry])
    lp, gp = plain.grad_fn(plain.params, *batch)
    assert abs(float(lk) - float(lp)) / abs(float(lp)) < 1e-5
    num = sum(float(((gk[k] - gp[k]).double() ** 2).sum()) for k in gp)
    den = sum(float((g.double() ** 2).sum()) for g in gp.values())
    assert (num / den) ** 0.5 < 1e-4
    loss = kern.train_step(*batch)
    assert loss.device.type == "cuda" and bool(torch.isfinite(loss))
    assert all(v.device.type == "cuda" for v in kern.params.values())


def test_ct_trainer_checkpoint_resume_on_the_card(tmp_path):
    """Fit 4 steps with checkpoints every 2, stopped after step 3; a new
    trainer restores the step-2 state and its next losses equal the
    uninterrupted run's (deterministic cuDNN); a completed run restores
    whole and fit() is then a no-op."""
    requires_cuda()
    from repro_torch.launch.ct_train import CTTrainer
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = _tiny_train("sparse_fan", steps=4, ckpt_every=2)
        full = CTTrainer(cfg).fit(log_every=0)

        def stop(i, loss):
            if i == 2:
                raise RuntimeError("stop")

        ck = cfg.replace(ckpt_dir=str(tmp_path / "ck"))
        with pytest.raises(RuntimeError, match="stop"):
            CTTrainer(ck).fit(log_every=0, on_step=stop)
        rest = CTTrainer(ck).fit(log_every=0)
        assert len(rest) == 2
        assert max(abs(a - b) / abs(b) for a, b in zip(rest, full[2:])) < 1e-6
        done = CTTrainer(ck)
        assert done.resume() == 4
        assert all(v.device.type == "cuda" for v in done.params.values())
        assert done.fit(log_every=0) == []
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


# --------------------------------------------------------------------------- #
# The autotuner and CT serving on the card
# --------------------------------------------------------------------------- #
SWEEP_GEOMS = {
    "parallel": lambda: (parallel_beam(40, 2, 96, VolumeGeometry(48, 40, 2)),
                         False),
    "fan": lambda: (fan_beam(36, 1, 120, VolumeGeometry(64, 64, 1), sod=120.0,
                             sdd=240.0), False),
    "cone-packed": lambda: (cone_beam(24, 4, 64, VolumeGeometry(32, 32, 4),
                                      sod=400.0, sdd=600.0), True),
}


@pytest.mark.parametrize("name", list(SWEEP_GEOMS))
def test_sweep_picks_a_measured_config_matching_plain(name):
    """A sweep times every candidate the layouts accept, keeps the fastest
    pair (in this process and on disk), and that configuration's kernels
    match their plain versions at 2e-4."""
    requires_cuda()
    g, packed = SWEEP_GEOMS[name]()
    batch = 3
    tune.clear()
    try:
        n0 = tune.sweep_count()
        cfg = tune.autotune(g, batch, packed=packed, device="cuda")
        assert tune.sweep_count() == n0 + 1
        rec = tune.last_sweep()
        key = tune.shape_class(g, batch, torch.float32, packed)
        assert rec["key"] == key and rec["tuned"] == cfg
        assert (cfg.lg, cfg.bu) in rec["fp_ms"] and (cfg.lg, cfg.bg) in rec["bp_ms"]
        assert rec["tuned_ms"] <= rec["heuristic_ms"]
        assert len(rec["fp_ms"]) >= 3 and len(rec["bp_ms"]) >= 3
        plan = {"parallel": ParallelPlan, "fan": FanPlan,
                "cone-packed": fp_fan.ConePackedPlan}[name](g)
        gen = torch.Generator(device="cuda").manual_seed(0)
        lanes = batch * g.n_rows
        vol = torch.randn((g.vol.nx, g.vol.ny, lanes), generator=gen,
                          device="cuda")
        sino = torch.randn((g.n_angles, g.n_cols, lanes), generator=gen,
                           device="cuda")
        for run, plain, x in ((fp_par.fp_lanes, fp_par.fp_lanes_plain, vol),
                              (fp_par.bp_lanes, fp_par.bp_lanes_plain, sino)):
            got = run(x, plan, cfg)
            want = plain(x, plan)
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel <= 2e-4, rel
        # read back from disk in a fresh registry, with no sweep
        tune.clear()
        assert tune.get_config(g, batch, packed=packed, device="cuda") == cfg
        assert tune.sweep_count() == n0 + 1
    finally:
        tune.clear()


def test_exact_cone_autotune_sweeps_nothing():
    """The exact cone and modular kernels take no configuration: autotune
    counts the call and returns without timing or writing to disk."""
    requires_cuda()
    g = cone_beam(12, 4, 40, VolumeGeometry(16, 16, 4), sod=80.0, sdd=160.0)
    tune.clear()
    try:
        n0 = tune.sweep_count()
        assert tune.autotune(g, 2, device="cuda") == tune.heuristic_config(g, 2)
        assert tune.sweep_count() == n0 + 1 and not tune.cache_path().exists()
    finally:
        tune.clear()


def _rel_l2(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.mark.parametrize("autotuned", [False, True])
def test_warm_server_on_the_card_answers_a_burst(autotuned, monkeypatch):
    """A warmed CTServer on the card answers a burst of four buckets with
    no sweep, op-cache miss or entry, new executor or library load, and
    launches the parallel and fan kernels.  Each answer is bit-equal to the
    solver on its own packed batch; against the request alone, SIRT and
    FISTA-TV are bit-equal (the kernels give a lane the same bits at any
    lane count), FBP within 2e-4 (its view chunks follow the batch), and
    CGLS, whose inner products reduce one sample at a time, within 2e-4 in
    the image and the residual history.  With autotuning on, the sweeps
    happen inside warm()."""
    requires_cuda()
    from repro_torch.launch.ct_serve import CTServer, ReconRequest
    from repro_torch.kernels import build, ops
    from repro_torch.recon import cgls, fista_tv, power_iteration, sirt
    monkeypatch.setenv(tune.AUTOTUNE_ENV, "1" if autotuned else "0")
    tune.clear()
    try:
        vol = VolumeGeometry(48, 48, 1)
        s_par = ProjectorSpec(parallel_beam(60, 1, 72, vol))
        s_fan = ProjectorSpec(fan_beam(60, 1, 96, vol, sod=100.0, sdd=200.0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.rand((10,) + vol.shape, generator=gen, device="cuda")
        y_par = Projector(s_par)(x).cpu().numpy()
        y_fan = Projector(s_fan)(x).cpu().numpy()
        L = float(power_iteration(Projector(s_par))) * 1.05
        solvers = {"sirt": sirt, "fista_tv": fista_tv, "cgls": cgls}
        buckets = [(s_par, y_par, "fbp", {}), (s_par, y_par, "sirt", {"n_iters": 8}),
                   (s_par, y_par, "fista_tv", {"n_iters": 5}),
                   (s_fan, y_fan, "cgls", {"n_iters": 6})]

        def solve(spec, solver, kw, y):
            y = torch.from_numpy(y).cuda()
            if solver == "fbp":
                return Projector(spec).fbp(y).cpu(), None
            kw = dict(kw, L=L) if solver == "fista_tv" else kw
            res = solvers[solver](Projector(spec), y, **kw)
            return res.image.cpu(), res.residual_history.cpu()

        srv = CTServer(max_batch=4)
        sweeps = tune.sweep_count()
        for spec, _, solver, kw in buckets:
            srv.warm(spec, solver, kw)
        assert (tune.sweep_count() > sweeps) == autotuned
        sweeps0, stats0 = tune.sweep_count(), ops.cache_stats()
        executors0, loaded0 = set(srv._executors), build.loaded()
        assert loaded0
        K.reset_launches()
        sent = {}
        for i in range(10):
            for b in buckets[: 4 if i < 6 else 2]:
                sent[srv.submit(ReconRequest(spec=b[0], sino=b[1][i], solver=b[2],
                                             solver_kwargs=dict(b[3])))] = (b, i)
        done = srv.drain()
        launches = K.launches()
        assert tune.sweep_count() == sweeps0
        assert ops.cache_stats()["size"] == stats0["size"]
        assert ops.cache_stats()["misses"] == stats0["misses"]
        assert set(srv._executors) == executors0 and build.loaded() == loaded0
        for k in ("fp_par_sf", "bp_par_sf", "fp_fan_sf", "bp_fan_sf"):
            assert launches[k] > 0, k
        tiers = [rec["tier"] for rec in srv.dispatch_log]
        assert tiers == sorted(tiers)              # interactive < quality
        for rec in srv.dispatch_log:
            (spec, y, solver, kw), _ = sent[rec["rids"][0]]
            pack = np.zeros((rec["size_class"],) + y.shape[1:], np.float32)
            for j, rid in enumerate(rec["rids"]):
                assert sent[rid][0][2] == solver
                pack[j] = y[sent[rid][1]]
            img, _ = solve(spec, solver, kw, pack)
            for j, rid in enumerate(rec["rids"]):
                assert done[rid].ok, done[rid].error
                assert torch.equal(done[rid].image, img[j]), (solver, j)
        for rid, ((spec, y, solver, kw), i) in sent.items():
            resp = done[rid]
            img, hist = solve(spec, solver, kw, y[i])
            if solver in ("sirt", "fista_tv"):
                assert torch.equal(resp.image, img), (solver, i)
            elif solver == "fbp":
                assert _rel_l2(resp.image, img) <= 2e-4, i
            else:
                rel = (resp.result.residual_history - hist).abs() / hist
                assert float(rel.max()) <= 2e-4 and _rel_l2(resp.image, img) <= 2e-4, i
    finally:
        tune.clear()
