"""The port's packed cone pair (``fp_fan.fp_fan_sf`` / ``bp_fan_sf`` on a
``fp_fan.ConePackedPlan``: the fan kernels' lanes around the
central-magnification axial pre-resample) and the ``mode``
policy, against the reference package: its error model and gate bit for
bit, its packed oracles ``fp_cone_packed_ref`` / ``bp_cone_packed_ref`` at
2e-4, and ``resolve_mode`` with the port's ``auto``/``cuda`` backends as the
reference's ``pallas`` and ``ref`` as its ``ref``.  CPU tensors run the
plain version of the resolved pair."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
import repro.kernels  # noqa: F401  (registers the reference's kernels)
from repro.kernels import fp_cone as jfp_cone
from repro.kernels import ops as jops
from repro.kernels import tune as jtune

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec, resolve_mode
from repro_torch import kernels as tkernels
from repro_torch.kernels import fp_cone, fp_fan, fp_par, ops, precision, tune
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fp_fan import ConePackedPlan, FanPlan

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _geom(G, sod=200.0, nz=4, nv=4, nxy=16, dz=1.0, dv=2.0, det="flat"):
    """tests/test_cone_packed.py's cone: 6 views, 24 columns of 2 mm."""
    vol = G.VolumeGeometry(nxy, nxy, nz, dz=dz)
    return G.cone_beam(6, nv, 24, vol, sod=sod, sdd=2.0 * sod,
                       pixel_width=2.0, pixel_height=dv, detector_type=det)


def _wide(G):
    """Past the gate: 16 slices of 2 mm at sod 40 (tests/test_cone_packed.py)."""
    return G.cone_beam(4, 16, 24, G.VolumeGeometry(16, 16, 16, dz=2.0),
                       sod=40.0, sdd=80.0, pixel_width=2.0, pixel_height=2.0)


def _slab(G):
    """The cone_packed card cell: a micro-CT slab, 512 x 512 x 8 voxels of
    50 um, 720 views, 8 x 768 pixels of 75 um, sod 1024, sdd 1536."""
    return G.cone_beam(720, 8, 768, G.VolumeGeometry(512, 512, 8, dx=0.05,
                                                     dy=0.05, dz=0.05),
                       sod=1024.0, sdd=1536.0, pixel_width=0.075,
                       pixel_height=0.075)


def _table1_cone(G):
    return G.cone_beam(180, 512, 768, G.VolumeGeometry(512, 512, 512),
                       sod=1024.0, sdd=2048.0, pixel_width=2.0,
                       pixel_height=2.0, angular_range=360.0)


GATE_GEOMS = {
    "sod400": lambda G: _geom(G, 400.0),
    "sod200": lambda G: _geom(G, 200.0),
    "sod60": lambda G: _geom(G, 60.0),
    "offset_z": lambda G: G.cone_beam(
        6, 6, 24, G.VolumeGeometry(16, 16, 6, dz=1.5, offset_z=2.5),
        sod=300.0, sdd=500.0, pixel_width=2.0, pixel_height=1.0),
    "wide": _wide,
    "slab": _slab,
    "table1_cone": _table1_cone,
}


def _data(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _blob_volume(vol, seed=0):
    """Smooth test volume (Gaussian blobs, tests/test_cone_packed.py): the
    regime packed mode targets."""
    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(np.linspace(-1, 1, vol.nx), np.linspace(-1, 1, vol.ny),
                          np.linspace(-1, 1, vol.nz), indexing="ij")
    f = np.zeros(vol.shape, np.float32)
    for _ in range(4):
        cx, cy, cz = rng.uniform(-0.5, 0.5, 3)
        w = rng.uniform(0.15, 0.4)
        f += np.exp(-((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
                    / (2 * w * w)).astype(np.float32)
    return torch.from_numpy(f)


def _packed(x, g, bp=False):
    """The port's packed pair on CPU tensors (its plain version)."""
    plan = ConePackedPlan(g)
    return (fp_fan.bp_fan_sf if bp else fp_fan.fp_fan_sf)(x, plan)


def _exact(x, g):
    return tref.forward(x, g, "sf")


# --------------------------------------------------------------------------- #
# The error model and the gate, bit for bit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(GATE_GEOMS))
def test_error_model_equals_the_reference(name):
    jg, tg = GATE_GEOMS[name](jgeo), GATE_GEOMS[name](tgeo)
    for fn in ("_z_edge_extent", "half_cone_tangent", "cone_packed_row_shift",
               "cone_packed_error_bound"):
        assert getattr(fp_cone, fn)(tg) == getattr(jfp_cone, fn)(jg), fn
    a, b = fp_cone._z_overlap_cone_packed(tg), jfp_cone._z_overlap_cone_packed(jg)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tune.packed_cone_ok(tg) == jtune.packed_cone_ok(jg)


def test_the_card_cells_sit_on_both_sides_of_the_gate():
    """The micro-CT slab passes the gate (0.072 rows, bound 0.144); the
    Table-1 cone cell does not (140 rows)."""
    slab, t1 = _slab(tgeo), _table1_cone(tgeo)
    assert tune.packed_cone_ok(slab) and not tune.packed_cone_ok(t1)
    assert fp_cone.cone_packed_row_shift(slab) < 0.08
    assert fp_cone.cone_packed_error_bound(slab) < 0.15
    assert fp_cone.cone_packed_row_shift(t1) > 100.0
    assert resolve_mode(ProjectorSpec(slab)) == "packed"
    assert resolve_mode(ProjectorSpec(t1)) == "exact"


def test_tolerance_env_override(monkeypatch):
    g = _geom(tgeo, 400.0)
    assert tune.packed_cone_tolerance() == tune.PACKED_CONE_DEFAULT_TOL == 0.25
    assert tune.packed_cone_ok(g)
    assert resolve_mode(g) == "packed"
    spec = ProjectorSpec(g)
    assert resolve_mode(spec) == "packed"
    monkeypatch.setenv("REPRO_TORCH_PACKED_CONE_TOL", "1e-9")
    assert not tune.packed_cone_ok(g)
    assert resolve_mode(g) == "exact"
    # a spec resolves once: it keeps its pair, new specs follow the variable
    assert resolve_mode(spec) == spec.resolved_mode == "packed"
    assert ProjectorSpec(g).resolved_mode == "exact"
    # the reference's variable does not move the port's gate
    monkeypatch.setenv("REPRO_TORCH_PACKED_CONE_TOL", "")
    monkeypatch.setenv("REPRO_PACKED_CONE_TOL", "1e-9")
    assert tune.packed_cone_ok(g)
    # a typo'd tolerance is loud, not a silent fallback to the default
    monkeypatch.setenv("REPRO_TORCH_PACKED_CONE_TOL", "0.1rows")
    with pytest.raises(ValueError, match="not a float"):
        tune.packed_cone_tolerance()
    with pytest.raises(ValueError, match="not a float"):
        resolve_mode(g)


# --------------------------------------------------------------------------- #
# The packed pair against the reference's packed oracle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("sod", [400.0, 60.0])
def test_packed_pair_matches_the_reference_oracle(sod, batch):
    jg, tg = _geom(jgeo, sod), _geom(tgeo, sod)
    lead = () if batch is None else (batch,)
    f = _data(lead + tg.vol.shape, 0)
    y = _data(lead + tg.sino_shape, 1)
    fs = f if batch else f[None]
    ys = y if batch else y[None]
    want_fp = np.stack([np.asarray(jfp_cone.fp_cone_packed_ref(jnp.asarray(x), jg))
                        for x in fs])
    want_bp = np.stack([np.asarray(jfp_cone.bp_cone_packed_ref(jnp.asarray(x), jg))
                        for x in ys])
    got_fp = _packed(torch.from_numpy(f), tg).numpy()
    got_bp = _packed(torch.from_numpy(y), tg, bp=True).numpy()
    np.testing.assert_allclose(got_fp.reshape(want_fp.shape), want_fp, **TOL)
    np.testing.assert_allclose(got_bp.reshape(want_bp.shape), want_bp, **TOL)


def test_packed_pair_in_bf16_within_bound_of_the_oracle():
    jg, tg = _geom(jgeo, 200.0), _geom(tgeo, 200.0)
    f = _data(tg.vol.shape, 2)
    want = np.asarray(jfp_cone.fp_cone_packed_ref(jnp.asarray(f), jg))
    plan = ConePackedPlan(tg)
    got = fp_fan.fp_fan_sf(torch.from_numpy(f), plan,
                           compute_dtype="bfloat16").numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < precision.BF16_FP_REL_BOUND, rel


@pytest.mark.parametrize("batch", [1, 3])
def test_packed_pair_dot_test(batch):
    g = _geom(tgeo)
    x = torch.from_numpy(_data((batch,) + g.vol.shape, 3))
    y = torch.from_numpy(_data((batch,) + g.sino_shape, 4))
    lhs = float(torch.sum(_packed(x, g).double() * y.double()))
    rhs = float(torch.sum(x.double() * _packed(y, g, bp=True).double()))
    assert abs(lhs - rhs) / abs(lhs) < 1e-4


def test_packed_batched_equals_per_sample():
    g = _geom(tgeo)
    x = torch.from_numpy(_data((3,) + g.vol.shape, 5))
    y = torch.from_numpy(_data((3,) + g.sino_shape, 6))
    torch.testing.assert_close(_packed(x, g),
                               torch.stack([_packed(x[i], g) for i in range(3)]),
                               **TOL)
    torch.testing.assert_close(_packed(y, g, bp=True),
                               torch.stack([_packed(y[i], g, bp=True)
                                            for i in range(3)]), **TOL)


def test_fan_limit_gives_the_fan_pair():
    """A thin central slice (nz = 1, one row covering the slice at the
    central magnification): the packed pair is the fan pair on the same
    scan, and within the bound of the exact cone pair."""
    vol = tgeo.VolumeGeometry(16, 16, 1, dz=1.0)
    g = tgeo.cone_beam(6, 1, 24, vol, sod=400.0, sdd=800.0, pixel_width=2.0,
                       pixel_height=2.0)
    fan = tgeo.fan_beam(6, 1, 24, vol, sod=400.0, sdd=800.0, pixel_width=2.0,
                        pixel_height=1.0)
    plan = ConePackedPlan(g)
    assert np.array_equal(plan.tables[0], FanPlan(fan).tables[0])
    assert np.array_equal(plan.fz, np.ones((1, 1), np.float32))
    f = torch.from_numpy(_data(vol.shape, 7))
    y = torch.from_numpy(_data(g.sino_shape, 8))
    torch.testing.assert_close(_packed(f, g), tref.forward(f, fan), **TOL)
    torch.testing.assert_close(_packed(y, g, bp=True), tref.adjoint(y, fan),
                               **TOL)
    exact = _exact(f, g)
    err = float(torch.linalg.vector_norm(_packed(f, g) - exact)
                / torch.linalg.vector_norm(exact))
    assert err <= fp_cone.cone_packed_error_bound(g) and err < 0.02


@pytest.mark.parametrize("sod", [400.0, 200.0, 100.0, 60.0])
def test_packed_error_within_bound_over_cone_angles(sod):
    """tests/test_cone_packed.py's half-cone-angle sweep on the port: the
    packed pair's relative L2 error against the exact cone pair stays under
    ``cone_packed_error_bound``."""
    g = _geom(tgeo, sod)
    f = _blob_volume(g.vol)
    exact = _exact(f, g)
    err = float(torch.linalg.vector_norm(_packed(f, g) - exact)
                / torch.linalg.vector_norm(exact))
    assert err <= fp_cone.cone_packed_error_bound(g), (err, sod)


def test_packed_plan_refuses_other_geometries():
    with pytest.raises(NotImplementedError, match="flat-detector cone"):
        ConePackedPlan(_geom(tgeo, det="curved"))
    with pytest.raises(NotImplementedError, match="flat-detector cone"):
        ConePackedPlan(tgeo.fan_beam(4, 1, 16, tgeo.VolumeGeometry(8, 8, 1),
                                     sod=40.0, sdd=80.0))
    # its config is the fan heuristic on batch x rows lanes
    g = _geom(tgeo, nz=8, nv=8)
    assert tune.resolve_config(g, 8, None) == tune.heuristic_config(g, 8)
    assert tune.heuristic_config(g, 8).lg == 8


# --------------------------------------------------------------------------- #
# The mode policy through ProjectorSpec / Projector
# --------------------------------------------------------------------------- #
def test_modes_are_honoured_on_cpu_tensors():
    """CPU tensors run the plain version of the resolved pair: "packed" and
    an auto that resolves packed give the packed composition, "exact" the
    exact pair; no kernel launches."""
    g = _geom(tgeo, 60.0)            # past the gate: auto is exact
    f = _blob_volume(g.vol)
    tkernels.reset_launches()
    packed = Projector(ProjectorSpec(g, mode="packed"), device="cpu")
    exact = Projector(ProjectorSpec(g, mode="exact"), device="cpu")
    auto = Projector(ProjectorSpec(g), device="cpu")
    assert torch.equal(packed(f), _packed(f, g))
    assert torch.equal(exact(f), _exact(f, g))
    assert torch.equal(auto(f), exact(f))
    assert float((packed(f) - exact(f)).abs().max()) > 0
    g2 = _geom(tgeo, 400.0)          # under the gate: auto is packed
    f2 = _blob_volume(g2.vol)
    assert torch.equal(Projector(ProjectorSpec(g2), device="cpu")(f2),
                       _packed(f2, g2))
    assert not any(tkernels.launches().values())


def test_auto_refuses_past_threshold():
    g = _wide(tgeo)
    assert fp_cone.cone_packed_row_shift(g) > tune.packed_cone_tolerance()
    assert not tune.packed_cone_ok(g)
    assert resolve_mode(g) == "exact"
    f = torch.from_numpy(_data(g.vol.shape, 9))
    torch.testing.assert_close(
        Projector(ProjectorSpec(g), device="cpu")(f), _exact(f, g), **TOL)


def test_packed_gradient_is_backprojection_and_twice_differentiable():
    g = _geom(tgeo, 400.0)
    proj = Projector(ProjectorSpec(g, mode="packed"), device="cpu")
    x = torch.from_numpy(_data(g.vol.shape, 10))
    y = torch.from_numpy(_data(g.sino_shape, 11))
    xg = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(0.5 * torch.sum((proj(xg) - y) ** 2), xg,
                                  create_graph=True)
    torch.testing.assert_close(grad, proj.T(proj(x) - y), rtol=1e-4, atol=1e-5)
    v = torch.from_numpy(_data(g.vol.shape, 12))
    (hv,) = torch.autograd.grad(torch.sum(grad * v), xg)
    torch.testing.assert_close(hv, proj.T(proj(v)), rtol=1e-4, atol=1e-5)


def test_spec_keys_follow_the_resolved_mode():
    g = _geom(tgeo, 400.0)
    auto, packed = ProjectorSpec(g), ProjectorSpec(g, mode="packed")
    exact = ProjectorSpec(g, mode="exact")
    assert auto != packed and hash(auto) != hash(packed)
    assert len({auto.bucket_key(), packed.bucket_key(), exact.bucket_key()}) == 3
    assert auto.cache_key("packed", "float32") == packed.cache_key("packed",
                                                                   "float32")
    assert "mode=packed" in repr(packed) and "mode=" not in repr(auto)
    proj = Projector(packed, device="cpu")
    assert proj.mode == "packed" and "mode=packed" in repr(proj)
    # "auto" and an explicit "packed" share one bundle
    ops.clear_cache()
    x = _blob_volume(g.vol)
    Projector(auto, device="cpu")(x)
    Projector(packed, device="cpu")(x)
    assert ops.cache_stats()["size"] == 1
    Projector(exact, device="cpu")(x)
    assert ops.cache_stats()["size"] == 2
    with pytest.raises(ValueError, match="unknown mode"):
        ProjectorSpec(g, mode="fast")
    with pytest.raises(ValueError, match="unknown mode"):
        resolve_mode(g, mode="fast")


def test_packed_mode_needs_a_packed_pair():
    gp = tgeo.parallel_beam(4, 2, 16, tgeo.VolumeGeometry(8, 8, 2))
    with pytest.raises(NotImplementedError, match="packed"):
        Projector(ProjectorSpec(gp, mode="packed"), device="cpu")(
            torch.zeros(gp.vol.shape))
    # curved-detector cone: the pre-resample is flat-only
    gc = _geom(tgeo, det="curved")
    with pytest.raises(NotImplementedError, match="flat-detector cone"):
        Projector(ProjectorSpec(gc, mode="packed"), device="cpu")(
            torch.zeros(gc.vol.shape))
    # the ref backend is exact: "auto" stays exact, "packed" raises
    g = _geom(tgeo, 400.0)
    assert resolve_mode(g, backend="ref") == "exact"
    with pytest.raises(NotImplementedError):
        Projector(ProjectorSpec(g, backend="ref", mode="packed"), device="cpu")(
            torch.zeros(g.vol.shape))
    entry = ops._KERNEL_TABLE[("cone", "sf")]
    assert entry.packed_plan is ConePackedPlan
    assert entry.packed_ok is tune.packed_cone_ok
    assert entry.fp_packed is fp_fan.fp_fan_sf
    assert entry.bp_packed is fp_fan.bp_fan_sf
    assert fp_par.LanePlan in ConePackedPlan.__mro__
    assert ConePackedPlan.launches is fp_fan.LAUNCHES


# --------------------------------------------------------------------------- #
# resolve_mode against the reference's
# --------------------------------------------------------------------------- #
def _tilted(G):
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    tilt = 0.15 * np.sin(2 * ang)
    src = np.stack([200 * np.cos(ang), 200 * np.sin(ang), 40 * tilt], -1)
    eu = np.stack([-np.sin(ang), np.cos(ang), np.zeros_like(ang)], -1)
    ev = np.cross(src / np.linalg.norm(src, axis=1, keepdims=True), eu)
    return G.modular_beam(src, -src, eu, ev, n_rows=8, n_cols=16,
                          vol=G.VolumeGeometry(12, 12, 6), pixel_width=2.0,
                          pixel_height=2.0)


MODE_GEOMS = {
    "cone_narrow": lambda G: _geom(G, 400.0),
    "cone_wide": _wide,
    "cone_curved": lambda G: _geom(G, 400.0, det="curved"),
    "slab": _slab,
    "table1_cone": _table1_cone,
    "parallel": lambda G: G.parallel_beam(4, 2, 16, G.VolumeGeometry(8, 8, 2)),
    "fan": lambda G: G.fan_beam(4, 1, 16, G.VolumeGeometry(8, 8, 1), sod=40.0,
                                sdd=80.0),
    "helical": lambda G: G.helical_beam(1.0, 8.0, 8, 6, 24,
                                        G.VolumeGeometry(16, 16, 8), sod=80.0,
                                        sdd=160.0, pixel_width=2.0,
                                        pixel_height=2.0),
    "tilted": _tilted,
}
# the port's backend -> the reference's
BACKENDS = {"auto": "pallas", "cuda": "pallas", "ref": "ref"}


def _outcome(fn):
    try:
        return fn()
    except NotImplementedError:
        return NotImplementedError


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("name", list(MODE_GEOMS))
def test_resolve_mode_agrees_with_the_reference(name, backend):
    jg, tg = MODE_GEOMS[name](jgeo), MODE_GEOMS[name](tgeo)
    for model in ("sf", "joseph"):
        for mode in ("auto", "exact", "packed"):
            want = _outcome(lambda: jops.resolve_mode(
                jg, model=model, backend=BACKENDS[backend], mode=mode))
            got = _outcome(lambda: resolve_mode(tg, model, backend, mode))
            assert got == want, (model, mode)
            spec = ProjectorSpec(tg, model=model, backend=backend, mode=mode)
            assert _outcome(lambda: resolve_mode(spec)) == want
