"""The port's axial-frame modular SF pair (the CPU path of the kernel
wrappers, and the ``ref`` backend) against the reference package: its frames
and per-view tables (bit for bit), its jnp oracle ``fp_modular_sf_ref`` /
``bp_modular_sf_ref`` and its Pallas kernels in interpret mode (rel < 1e-4,
as ``tests/test_modular.py``), and the port's own exact cone pair on an
axial circular trajectory (rel < 2e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
from repro.kernels import fp_modular as jfm
from repro.kernels import ref as jref

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec
from repro_torch import kernels as tkernels
from repro_torch.kernels import fp_cone, fp_modular, ops, precision
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fp_modular import ModularPlan


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# Geometries of tests/test_modular.py, built by either package (G)
# --------------------------------------------------------------------------- #
def _helical(G, nz=8, na=8):
    return G.helical_beam(1.0, 8.0, na, 10, 24, G.VolumeGeometry(16, 16, nz),
                          sod=80.0, sdd=160.0, pixel_width=2.0,
                          pixel_height=2.0)


def _wobbly(G, na=7, nv=10, nu=24, seed=3):
    """tests/test_modular.py:38-57: non-uniform angles, per-view sod/sdd/
    source-z wobble, per-view detector shifts, e_v flipped on odd views."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, na))
    sod = 80.0 + rng.uniform(-5, 5, na)
    sdd = 160.0 + rng.uniform(-10, 10, na)
    zsrc = rng.uniform(-4, 4, na)
    c, s = np.cos(ang), np.sin(ang)
    src = np.stack([sod * c, sod * s, zsrc], -1)
    eu = np.stack([-s, c, np.zeros(na)], -1)
    evz = np.where(np.arange(na) % 2 == 0, 1.0, -1.0)
    ev = np.stack([np.zeros(na), np.zeros(na), evz], -1)
    ctr = (np.stack([(sod - sdd) * c, (sod - sdd) * s, zsrc], -1)
           + rng.uniform(-3, 3, na)[:, None] * eu
           + rng.uniform(-3, 3, na)[:, None] * ev)
    return G.modular_beam(src, ctr, eu, ev, n_rows=nv, n_cols=nu,
                          vol=G.VolumeGeometry(16, 16, 8), pixel_width=2.0,
                          pixel_height=2.0)


def _cone(G):
    return G.cone_beam(6, 10, 24, G.VolumeGeometry(16, 16, 8), sod=80.0,
                       sdd=160.0, pixel_width=2.0, pixel_height=2.0)


def _cone_as_modular(G):
    return G.cone_as_modular(_cone(G))


def _tilted(G):
    g = _wobbly(G)
    ev = np.asarray(g.det_v).copy()
    ev[:, 0] = 0.2
    ev /= np.linalg.norm(ev, axis=1, keepdims=True)
    return G.modular_beam(g.source_pos, g.det_center, g.det_u, ev, g.n_rows,
                          g.n_cols, g.vol, g.pixel_width, g.pixel_height)


def _source_inside(G):
    na = 4
    ang = np.linspace(0, 2 * np.pi, na, endpoint=False)
    c, s = np.cos(ang), np.sin(ang)
    src = np.stack([5.0 * c, 5.0 * s, np.zeros(na)], -1)
    ctr = np.stack([-100.0 * c, -100.0 * s, np.zeros(na)], -1)
    eu = np.stack([-s, c, np.zeros(na)], -1)
    ev = np.stack([np.zeros(na), np.zeros(na), np.ones(na)], -1)
    return G.modular_beam(src, ctr, eu, ev, 4, 24, G.VolumeGeometry(16, 16, 8))


def _tall(G):
    """tests/test_modular.py:169: nz far above the axial window while the
    source translates in z."""
    return G.helical_beam(1.0, 16.0, 6, 6, 24, G.VolumeGeometry(16, 16, 24),
                          sod=80.0, sdd=120.0, pixel_width=2.0,
                          pixel_height=1.0)


AXIAL = {"helical": _helical, "wobbly": _wobbly,
         "cone_as_modular": _cone_as_modular}
GATED = {"tilted": _tilted, "source_inside": _source_inside, **AXIAL}


def _data(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


# --------------------------------------------------------------------------- #
# Frames and tables
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", AXIAL)
def test_view_params_modular_bit_identical(name):
    jg, tg = AXIAL[name](jgeo), AXIAL[name](tgeo)
    got = fp_modular._view_params_modular(tg)
    want = jfm._view_params_modular(jg)
    for a, b in zip(got[:3], want[:3]):             # px, py, order
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == want[3]                        # sdd_ref
    plan = ModularPlan(tg)
    fr = jfm._frames(jg)
    assert plan.sdd_ref == want[3]
    assert plan.mag_bounds == jfm._mag_bounds_modular(jg, fr)
    assert np.array_equal(np.concatenate(plan.rows), want[2].astype(np.int32))


@pytest.mark.parametrize("name", GATED)
def test_frames_axial_gate_matches_reference(name):
    jg, tg = GATED[name](jgeo), GATED[name](tgeo)
    assert fp_modular.modular_frames_axial(tg) == jfm.modular_frames_axial(jg)
    assert fp_modular.modular_frames_axial(tg) == (name in AXIAL)


def test_footprint_halfwidth_bounds_every_corner():
    """The FP kernel's voxel window rests on hw: no corner of any voxel
    projects farther than hw from its centre, in any view (wobbly frames:
    per-view sdd, detector shifts, flipped e_v)."""
    tg = _wobbly(tgeo)
    plan = ModularPlan(tg)
    for grp in (0, 1):
        table = torch.from_numpy(plan.tables[grp])
        ng, nl = plan.group(grp)[:2]
        gi = torch.arange(ng, dtype=torch.float32)[None, :, None]
        li = torch.arange(nl, dtype=torch.float32)[None, None, :]
        t0, _, _, t3, _, _, ell = fp_cone._corner_trapezoid(
            table, gi, li, plan.sdd, plan.dxv, False)
        col = [table[:, k].reshape(-1, 1, 1) for k in range(6)]
        uc = plan.sdd * (col[0] * gi + col[1] * li + col[2]) / ell
        spread = torch.maximum(t3 - uc, uc - t0).max()
        assert 0.0 < float(spread) <= plan.hw


# --------------------------------------------------------------------------- #
# The pair against the reference's oracle and Pallas kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["helical", "wobbly"])
def test_fp_bp_match_reference_oracle(name):
    jg, tg = AXIAL[name](jgeo), AXIAL[name](tgeo)
    plan = ModularPlan(tg)
    f, y = _data(tg.vol.shape, 0), _data(tg.sino_shape, 1)
    p_ref = np.asarray(jfm.fp_modular_sf_ref(jnp.asarray(f), jg))
    b_ref = np.asarray(jfm.bp_modular_sf_ref(jnp.asarray(y), jg))
    assert _rel(fp_modular.fp_modular_sf(torch.from_numpy(f), plan), p_ref) < 1e-4
    assert _rel(fp_modular.bp_modular_sf(torch.from_numpy(y), plan), b_ref) < 1e-4
    assert _rel(tref.forward(torch.from_numpy(f), tg), p_ref) < 1e-4
    assert _rel(tref.adjoint(torch.from_numpy(y), tg), b_ref) < 1e-4


@pytest.mark.parametrize("name", ["helical", "wobbly"])
def test_fp_bp_match_pallas_interpret(name):
    jg, tg = AXIAL[name](jgeo), AXIAL[name](tgeo)
    plan = ModularPlan(tg)
    f, y = _data(tg.vol.shape, 2), _data(tg.sino_shape, 3)
    assert _rel(fp_modular.fp_modular_sf(torch.from_numpy(f), plan),
                jfm.fp_modular_sf_pallas(jnp.asarray(f), jg)) < 1e-4
    assert _rel(fp_modular.bp_modular_sf(torch.from_numpy(y), plan),
                jfm.bp_modular_sf_pallas(jnp.asarray(y), jg)) < 1e-4


def test_cone_as_modular_matches_cone_plain():
    """On an axial circular trajectory the modular pair is the cone pair."""
    tc, tm = _cone(tgeo), _cone_as_modular(tgeo)
    f, y = _data(tc.vol.shape, 4), _data(tc.sino_shape, 5)
    cp, mp = fp_cone.ConePlan(tc), ModularPlan(tm)
    assert _rel(fp_modular.fp_modular_sf(torch.from_numpy(f), mp),
                fp_cone.fp_cone_sf(torch.from_numpy(f), cp)) < 2e-5
    assert _rel(fp_modular.bp_modular_sf(torch.from_numpy(y), mp),
                fp_cone.bp_cone_sf(torch.from_numpy(y), cp)) < 2e-5


def test_tall_volume_sliding_z_window():
    jg, tg = _tall(jgeo), _tall(tgeo)
    f, y = _data(tg.vol.shape, 6), _data(tg.sino_shape, 7)
    plan = ModularPlan(tg)
    assert _rel(fp_modular.fp_modular_sf(torch.from_numpy(f), plan),
                jfm.fp_modular_sf_ref(jnp.asarray(f), jg)) < 1e-4
    assert _rel(fp_modular.bp_modular_sf(torch.from_numpy(y), plan),
                jfm.bp_modular_sf_ref(jnp.asarray(y), jg)) < 1e-4


def test_batched_4d_matches_per_sample():
    tg = _wobbly(tgeo)
    plan = ModularPlan(tg)
    f = torch.from_numpy(_data((3,) + tg.vol.shape, 8))
    y = torch.from_numpy(_data((3,) + tg.sino_shape, 9))
    fb, bb = fp_modular.fp_modular_sf(f, plan), fp_modular.bp_modular_sf(y, plan)
    for i in range(3):
        torch.testing.assert_close(fb[i], fp_modular.fp_modular_sf(f[i], plan),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(bb[i], fp_modular.bp_modular_sf(y[i], plan),
                                   rtol=1e-5, atol=1e-5)


def test_bf16_within_bound_of_reference():
    jg, tg = _helical(jgeo), _helical(tgeo)
    plan = ModularPlan(tg)
    f, y = _data(tg.vol.shape, 10), _data(tg.sino_shape, 11)
    p_ref = np.asarray(jref.forward(jnp.asarray(f), jg, "sf", dtype="bfloat16"))
    b_ref = np.asarray(jref.adjoint(jnp.asarray(y), jg, "sf", dtype="bfloat16"))
    p = fp_modular.fp_modular_sf(torch.from_numpy(f), plan, compute_dtype="bf16")
    b = fp_modular.bp_modular_sf(torch.from_numpy(y), plan, compute_dtype="bf16")
    assert p.dtype == torch.float32 and b.dtype == torch.float32
    for got, want in ((p.numpy(), p_ref), (b.numpy(), b_ref)):
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < precision.BF16_FP_REL_BOUND, rel
    assert not torch.equal(p, fp_modular.fp_modular_sf(torch.from_numpy(f), plan))


# --------------------------------------------------------------------------- #
# The Projector: matched pair, dispatch and the axial gate
# --------------------------------------------------------------------------- #
def test_dot_gradient_and_double_backward():
    tg = _wobbly(tgeo)
    proj = Projector(ProjectorSpec(tg), device="cpu")
    x = torch.from_numpy(_data((2,) + tg.vol.shape, 12))
    y = torch.from_numpy(_data((2,) + tg.sino_shape, 13))
    lhs = float((proj(x).double() * y.double()).sum())
    rhs = float((x.double() * proj.T(y).double()).sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-4
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - y) ** 2), xg,
                                  create_graph=True)
    torch.testing.assert_close(grad, proj.T(proj(x) - y), rtol=1e-4, atol=1e-5)
    v = torch.from_numpy(_data((2,) + tg.vol.shape, 14))
    (hv,) = torch.autograd.grad(torch.sum(grad * v), xg)
    torch.testing.assert_close(hv, proj.T(proj(v)), rtol=1e-4, atol=1e-5)


def _cone_tiles(G):
    """A cone whose detector spans 3 x 2 FP tiles of 32 x 32, both ragged."""
    return G.cone_beam(12, 40, 70, G.VolumeGeometry(20, 20, 16), sod=60.0,
                       sdd=120.0, pixel_width=1.0, pixel_height=1.0)


def _fp_pattern(plan, lay):
    """From the plain version's nonzero weights (``fp_cone.chunk_taps``):
    the most columns one voxel meets in a view, the most voxels of one
    (view, column tile, row tile, li) with a nonzero there, and the most
    slices of one (view, voxel, row tile) with a nonzero there, for the FP
    tile of ``lay``."""
    geom = plan.geom
    nu, nv, nz = geom.n_cols, geom.n_rows, geom.vol.nz
    nct, nrt = -(-nu // lay.tu), -(-nv // lay.tv)
    dt = plan.on(torch.device("cpu"))
    cols = vox = slices = 0
    for grp in (0, 1):
        ng, nl = plan.group(grp)[:2]
        table = dt.tables[grp]
        nvw = table.shape[0]
        if nvw == 0:
            continue
        umin = torch.full((nvw, ng * nl), nu)
        umax = torch.full((nvw, ng * nl), -1)
        hit_v = torch.zeros((nvw, nct, nrt, ng, nl), dtype=torch.bool)
        hit_s = torch.zeros((nvw, ng * nl, nrt, nz), dtype=torch.bool)
        for pix, wu, wz in fp_cone.chunk_taps(plan, table, ng, nl, 0, nz,
                                              torch.empty(0)):
            m = (wu * wz) != 0
            u, v = pix % nu, pix // nu
            anyz = m.any(-1)
            umin = torch.where(anyz, torch.minimum(umin, u[..., 0]), umin)
            umax = torch.where(anyz, torch.maximum(umax, u[..., 0]), umax)
            a, n, k = m.nonzero(as_tuple=True)
            ct, rt = u[a, n, k] // lay.tu, v[a, n, k] // lay.tv
            hit_v[a, ct, rt, n // nl, n % nl] = True
            hit_s[a, n, rt, k] = True
        cols = max(cols, int((umax - umin + 1).max()))
        vox = max(vox, int(hit_v.sum(3).max()))
        slices = max(slices, int(hit_s.sum(-1).max()))
    return cols, vox, slices


@pytest.mark.parametrize("make", [_cone_tiles, _wobbly, _helical, _tall],
                         ids=lambda m: m.__name__[1:])
def test_fp_layout_bounds_hold_the_nonzero_pattern(make):
    """The host's sizes of the FP kernel's shared buffers
    (``fp_cone.fp_layout``) against the plain version's nonzero pattern:
    a voxel's columns within ``ncap`` (and within the bound ceil(2 hw / du)
    + 2 that ``ncap`` is derived from), a tile's slices of a voxel within
    ``nslice``, and a tile's voxels within one pass (``smax``) unless the
    layout walks windows in passes.  An empty pass holds any one voxel."""
    g = make(tgeo)
    plan = (fp_cone.ConePlan if g.geom_type == "cone" else ModularPlan)(g)
    for spt in (1, 8):
        lay = fp_cone.fp_layout(plan, spt)
        cols, vox, slices = _fp_pattern(plan, lay)
        bound = int(np.ceil(2 * plan.hw / plan.du)) + 2
        assert cols <= bound <= lay.ncap, (cols, lay)
        assert slices <= lay.nslice, (slices, lay)
        assert vox <= lay.smax or lay.passes, (vox, lay)
        assert vox <= lay.window
        nz = g.vol.nz
        assert lay.emax >= nz and lay.smax >= 1
        assert lay.smem_bytes * fp_cone.FP_BLOCKS[spt] <= 227 * 1024
        assert lay.tv == min(g.n_rows, fp_cone.FP_MAX_ROWS)
        assert lay.tu == (fp_cone.FP_THREADS // lay.tv) * fp_cone.FP_COLS


@pytest.mark.parametrize("dv", [1e-7, 2.0e6])
def test_fp_layout_refuses_pitches_outside_the_exact_division(dv):
    """The FP kernel's division by the row pitch is proven exact for pitches
    in ``FP_DV_RANGE``: the layout refuses others (the plain version, on
    the CPU, takes any pitch)."""
    g = tgeo.cone_beam(4, 6, 10, tgeo.VolumeGeometry(8, 8, 4), sod=60.0,
                       sdd=120.0, pixel_width=1.0, pixel_height=dv)
    plan = fp_cone.ConePlan(g)
    with pytest.raises(ValueError, match="row pitch"):
        fp_cone.fp_layout(plan, 1)
    assert fp_cone.fp_layout(fp_cone.ConePlan(_cone_tiles(tgeo)), 1).smax >= 1


def _bp_rows(plan):
    """The most detector rows one slice of one voxel meets with a nonzero
    axial weight in a view, from the plain version's weights
    (``fp_cone.chunk_taps``; the axial weight is the same at every column
    tap, so each tap's rows are counted once per column tap)."""
    nz = plan.geom.vol.nz
    dt = plan.on(torch.device("cpu"))
    rows = 0
    for grp in (0, 1):
        ng, nl = plan.group(grp)[:2]
        table = dt.tables[grp]
        if table.shape[0] == 0:
            continue
        nrow = 0
        for _, _, wz in fp_cone.chunk_taps(plan, table, ng, nl, 0, nz,
                                           torch.empty(0)):
            nrow = nrow + (wz != 0).to(torch.int64)
        rows = max(rows, int(nrow.max()) // plan.taps_u)
    return rows


@pytest.mark.parametrize("make", [_cone_tiles, _wobbly, _helical, _tall],
                         ids=lambda m: m.__name__[1:])
def test_bp_layout_bounds_hold_the_nonzero_pattern(make):
    """The host's bound for the BP kernel (``fp_cone.bp_layout``) against
    the plain version's nonzero pattern: the rows one slice meets within
    ``rows``, which picks the body that keeps each slice's axial weights
    (``cached``, as on every cell of ``chip_smoke.py``)."""
    g = make(tgeo)
    plan = (fp_cone.ConePlan if g.geom_type == "cone" else ModularPlan)(g)
    lay = fp_cone.bp_layout(plan)
    rows = _bp_rows(plan)
    assert 1 <= rows <= lay.rows <= fp_cone.BP_ROWS, (rows, lay)
    assert lay.cached


@pytest.mark.parametrize("dv", [1e-7, 2.0e6])
def test_bp_layout_refuses_pitches_outside_the_exact_division(dv):
    """The BP kernel divides by the row pitch as the FP does (``sf_div_rn``,
    proven for pitches in ``FP_DV_RANGE``): its layout refuses others."""
    g = tgeo.cone_beam(4, 6, 10, tgeo.VolumeGeometry(8, 8, 4), sod=60.0,
                       sdd=120.0, pixel_width=1.0, pixel_height=dv)
    with pytest.raises(ValueError, match="row pitch"):
        fp_cone.bp_layout(fp_cone.ConePlan(g))
    assert fp_cone.bp_layout(fp_cone.ConePlan(_cone_tiles(tgeo))).cached


@pytest.mark.parametrize("backend", ["auto", "ref", "cuda"])
@pytest.mark.parametrize("make", [_tilted, _source_inside],
                         ids=["tilted", "source_inside"])
def test_unsupported_frames_raise_not_implemented(make, backend):
    """Frames the SF kernels do not cover: backend="cuda" raises (the plan
    refuses them); "auto" and "ref" run the Joseph ray-marcher under
    model="sf", as the reference's fp_modular_sf_ref does."""
    g = make(tgeo)
    proj = Projector(ProjectorSpec(g, backend=backend), device="cpu")
    x = torch.from_numpy(_data(g.vol.shape, 0))
    y = torch.from_numpy(_data(g.sino_shape, 1))
    if backend == "cuda":
        with pytest.raises(NotImplementedError, match="supports axial frames"):
            proj(x)
        with pytest.raises(NotImplementedError, match="supports axial frames"):
            proj.T(y)
        return
    # (the Joseph adjoint sums scattered terms in no fixed order)
    torch.testing.assert_close(proj(x), tref.forward(x, g, "joseph"),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(proj.T(y), tref.adjoint(y, g, "joseph"),
                               rtol=1e-5, atol=1e-5)


def test_supports_gate_registered_and_launches_listed():
    entry = ops._KERNEL_TABLE[("modular", "sf")]
    assert entry.plan is ModularPlan
    # the axial gate sits in the plan, which every backend builds first
    assert fp_modular.modular_frames_axial(_helical(tgeo))
    assert not fp_modular.modular_frames_axial(_tilted(tgeo))
    assert entry.supports is fp_modular.modular_frames_axial
    with pytest.raises(NotImplementedError, match="supports axial frames"):
        ModularPlan(_tilted(tgeo))
    counts = tkernels.launches()
    assert {"fp_modular_sf", "bp_modular_sf"} <= set(counts)
    # CPU tensors run the plain versions: no launch
    tkernels.reset_launches()
    proj = Projector(ProjectorSpec(_helical(tgeo)), device="cpu")
    proj.T(proj(torch.ones(proj.vol_shape())))
    assert tkernels.launches()["fp_modular_sf"] == 0
    assert tkernels.launches()["bp_modular_sf"] == 0
