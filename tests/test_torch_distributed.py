"""The port's sharded recon (``repro_torch.core.distributed`` on
``torch.distributed``) against the reference package's
``repro.core.distributed``, on the CPU.

* Host code without a world: ``ShardSpec`` and its errors, the spec keys
  with and without a shard, ``suggest_halo``, ``_views_z_extent``, the
  chunk geometries, ``_auto_comm_blocks``, the layout checks and the
  legacy ``as_spec`` shim, each against the reference.
* A (1, 1) gloo world: the pair against the reference's
  ``DistributedProjector`` on a jax (1, 1) mesh (read with ``np.asarray``),
  the legacy factory, the validation errors, and every solver (SIRT, CGLS,
  FISTA-TV, the power iteration, the refinement, complete-and-refine, the
  projection residual) bit-equal to one device.
* A 4-rank gloo world: the halo pair against its numpy oracle; parallel
  (2, 2) against the reference's own sharded pair (``backend="ref"``, in a
  subprocess with 4 forced host devices); cone (2, 2) and helical (1, 4)
  against the reference's and the port's single-device ops; dot tests,
  overlap against psum, the helical SIRT and CGLS against one device, the
  gradient and double backward through the sharded pair, and the solvers
  on parallel (2, 2) and cone (2, 2): FISTA-TV (its ``L`` given, and with
  its own power iteration), the refinement, complete-and-refine and the
  projection residual against the port's single device (1e-5 relative),
  FISTA-TV and the refinement also against the reference's single-device
  solvers on the gathered problem (5e-4, ``tests/test_torch_solvers.py``'s
  bound).  The reference's sharded solvers cannot
  serve as the oracle: on its (2, 2) mesh of forced host devices
  ``power_iteration``, ``fista_tv`` and ``data_consistency_refine`` raise
  ``ShardingTypeError`` (a reshape of a z-sharded array in ``z.ravel()``,
  and ``jnp.vdot``) under the installed jax.

Tolerances are the reference tests' (``tests/test_distributed_ct.py``): the
pair within 2e-5 (BP atol 2e-5 max|BP|), dot tests under 1e-6, overlap
against psum 1e-5, SIRT 1e-4; the other solvers 1e-5 relative to the
largest entry against the port's single device.  Each
world runs all its checks in one spawn
(``tests/torch_dist_worlds.py``) with a timeout of its own.
"""
import dataclasses
import inspect
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.geometry as jgeo
from repro.core import ProjectorSpec as JSpec
from repro.core import distributed as JD
from repro.core import spec as jspec
from repro.configs.leap_ct import table1_geometries as jtable1
from repro.kernels import ops as jops
from repro import recon as jrecon

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec, ShardSpec
from repro_torch.configs.leap_ct import table1_geometries
from repro_torch.core import distributed as TD
from repro_torch.core import spec as tspec
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import RankError, run_world
from repro_torch.recon import (cgls, complete_and_refine,
                               data_consistency_refine, fista_tv,
                               power_iteration, projection_residual, sirt)
from repro_torch.recon.result import as_projector

import torch_dist_worlds as W

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _both(name):
    return W.make_geom(jgeo, name), W.make_geom(tgeo, name)


def _vs(got, want, tol=TOL, bp=False):
    atol = tol * float(np.max(np.abs(want))) if bp else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _local_pair(geom, seed=0):
    """The port's single-device pair on the inputs of ``W._pair``."""
    proj = Projector(ProjectorSpec(geom), "cpu")
    x = torch.from_numpy(W.data(geom.vol.shape, seed))
    y = torch.from_numpy(W.data(geom.sino_shape, seed + 1))
    return proj(x).numpy(), proj.T(y).numpy()


def _ref_local_pair(geom, seed=0):
    """The reference's single-device ops (its jnp pair on the CPU)."""
    fp, bp = jops.get_ops(JSpec(geom))
    x = jnp.asarray(W.data(geom.vol.shape, seed))
    y = jnp.asarray(W.data(geom.sino_shape, seed + 1))
    return np.asarray(fp(x)), np.asarray(bp(y))


# --------------------------------------------------------------------------- #
# Host code, no world
# --------------------------------------------------------------------------- #
SHARD_ERRORS = [
    (dict(mesh_axes=("data",)), "mesh_axes"),
    (dict(mesh_axes=(None, "model")), "angle axis"),
    (dict(mesh_axes=("data", "data")), "distinct"),
    (dict(angle_shards=0), ">= 1"),
    (dict(mesh_axes=("data", None), z_shards=2), "z mesh axis"),
    (dict(halo=-1), "halo"),
    (dict(z_shards=1, halo=2), "meaningless"),
    (dict(comm="ring"), "comm"),
    (dict(comm_blocks=-1), "comm_blocks"),
]


@pytest.mark.parametrize("kw,match", SHARD_ERRORS,
                         ids=[m for _, m in SHARD_ERRORS])
def test_shard_spec_errors_match_reference(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        ShardSpec(**kw)
    with pytest.raises(ValueError) as ref:
        jspec.ShardSpec(**kw)
    assert str(mine.value) == str(ref.value)


def test_shard_spec_hash_roundtrip():
    a = ShardSpec(("data", "model"), angle_shards=4, z_shards=2, halo=3)
    b = ShardSpec(("data", "model"), angle_shards=4, z_shards=2, halo=3)
    assert a == b and hash(a) == hash(b)
    assert a.replace(halo=2) != a
    assert a.angle_axis == "data" and a.z_axis == "model"
    c = ShardSpec(**dataclasses.asdict(a))
    assert c == a and hash(c) == hash(a)
    assert len({a, b, a.replace(comm="overlap")}) == 2


def test_default_comm_is_one_all_reduce():
    """The port's default BP schedule is one all-reduce: each overlap block
    reduces a whole slab, and one all-reduce was faster on every cell
    measured.  ``"overlap"`` stays selectable, as in the reference."""
    assert ShardSpec().comm == "psum" and jspec.ShardSpec().comm == "overlap"
    sig = inspect.signature(TD.distribute).parameters
    assert sig["comm"].default == "psum"
    assert ShardSpec(comm="overlap").comm == "overlap"


def test_spec_keys_without_shard_unchanged():
    """``shard=None`` keeps the keys of the spec before shards existed: the
    serving buckets and the tune disk cache are keyed by them."""
    import hashlib
    import json
    g = tgeo.parallel_beam(8, 4, 24, tgeo.VolumeGeometry(16, 16, 4))
    spec = ProjectorSpec(g, compute_dtype="bf16")
    h = g.canonical_hash()
    assert spec._identity() == (h, "sf", "auto", "auto", "bfloat16", None)
    assert hash(spec) == hash((h, "sf", "auto", "auto", "bfloat16", None))
    assert spec.cache_key("exact", "float32") == (
        h, "sf", "auto", None, "exact", "bfloat16", "float32")
    payload = json.dumps([h, "sf", "auto", "auto", "bfloat16", None])
    assert spec.bucket_key() == hashlib.sha256(payload.encode()).hexdigest()[:16]


SHARDS = [ShardSpec(("data", None), angle_shards=4),
          ShardSpec(("data", "model"), angle_shards=2, z_shards=2, halo=1),
          ShardSpec(("data", "model"), angle_shards=1, z_shards=4, halo=4,
                    comm="overlap", comm_blocks=2)]


@pytest.mark.parametrize("name", ["par", "cone", "helical"])
def test_bucket_key_with_shard_matches_reference(name):
    jg, tg = _both(name)
    for s in SHARDS:
        mine = ProjectorSpec(tg, shard=s)
        ref = JSpec(jg, shard=jspec.ShardSpec(**dataclasses.asdict(s)))
        assert mine.bucket_key() == ref.bucket_key()


def test_shard_participates_in_spec_identity():
    g = W.make_geom(tgeo, "par")
    shard = ShardSpec(("data", "model"), angle_shards=2, z_shards=2, halo=1)
    plain, sharded = ProjectorSpec(g), ProjectorSpec(g, shard=shard)
    assert plain != sharded and hash(plain) != hash(sharded)
    assert plain.bucket_key() != sharded.bucket_key()
    assert plain.cache_key() != sharded.cache_key()
    again = ProjectorSpec(g, shard=ShardSpec(("data", "model"), angle_shards=2,
                                             z_shards=2, halo=1))
    assert sharded == again and hash(sharded) == hash(again)
    other = ProjectorSpec(g, shard=shard.replace(comm="overlap"))
    assert other != sharded and other.bucket_key() != sharded.bucket_key()
    with pytest.raises(TypeError, match="ShardSpec"):
        ProjectorSpec(g, shard="angle")
    assert "shard=" in repr(sharded)


def test_op_cache_refuses_sharded_spec():
    g = W.make_geom(tgeo, "par_pair")
    spec = ProjectorSpec(g, shard=ShardSpec(("data", None)))
    x = torch.zeros(g.vol.shape)
    for call in (lambda: tops.get_ops(spec, x),
                 lambda: tops.forward_project(x, spec),
                 lambda: Projector(spec, "cpu")(x)):
        with pytest.raises(ValueError, match="DistributedProjector"):
            call()


def test_as_projector_refuses_sharded_spec():
    g = W.make_geom(tgeo, "par_pair")
    with pytest.raises(ValueError, match="mesh"):
        as_projector(ProjectorSpec(g, shard=ShardSpec(("data", None))))


def test_as_spec_warns_once_and_refuses_mixing():
    g = W.make_geom(tgeo, "par_pair")
    tspec.reset_legacy_warnings()
    with pytest.warns(DeprecationWarning, match="geometry-first"):
        spec = tspec.as_spec(g, "probe", mode="exact")
    assert spec == ProjectorSpec(g, mode="exact")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tspec.as_spec(g, "probe")                   # second call: silent
        assert tspec.as_spec(spec, "probe") is spec
    with pytest.raises(TypeError, match="not both"):
        tspec.as_spec(spec, "probe", mode="packed")
    with pytest.raises(TypeError, match="expected a ProjectorSpec"):
        tspec.as_spec(42, "probe")


def _long_helical(geo):
    """The card's helical_long cell: the helical cell's widths over a long
    object (8 turns of 8 mm pitch, 3072 views, 6 x 1126 detector)."""
    return geo.helical_beam(n_turns=8, pitch=8.0, n_angles=3072, n_rows=6,
                            n_cols=1126, vol=geo.VolumeGeometry(512, 512, 64),
                            sod=1024.0, sdd=1536.0, pixel_height=2.0)


def _halo_cases():
    vol = (24, 24, 8)
    small = dict(
        par=lambda geo: geo.parallel_beam(8, 8, 36, geo.VolumeGeometry(*vol)),
        cone=lambda geo: geo.cone_beam(8, 8, 36, geo.VolumeGeometry(*vol),
                                       sod=60.0, sdd=80.0),
        helical=lambda geo: W.make_geom(geo, "helical"))
    cases = [("par", 2, None), ("cone", 2, None), ("helical", 4, None),
             ("helical", 1, 0)]
    out = [(small[n], z, want, f"{n}_{z}") for n, z, want in cases]
    out += [(lambda geo: (jtable1() if geo is jgeo else table1_geometries())[
                 "parallel_512_180"], 2, 0, "parallel_512_180_2"),
            (lambda geo: (jtable1() if geo is jgeo else table1_geometries())[
                 "cone_512_180"], 2, 1, "cone_512_180_2"),
            (lambda geo: (jtable1() if geo is jgeo else table1_geometries())[
                 "cone_512_180"], 4, 52, "cone_512_180_4")]
    out += [(_long_helical, z, 7, f"helical_long_{z}") for z in (2, 4, 8)]
    return out


@pytest.mark.parametrize("make,z,want", [c[:3] for c in _halo_cases()],
                         ids=[c[3] for c in _halo_cases()])
def test_suggest_halo_matches_reference(make, z, want):
    h = TD.suggest_halo(make(tgeo), z)
    assert h == JD.suggest_halo(make(jgeo), z)
    if want is not None:
        assert h == want


def test_suggest_halo_checks_divisibility():
    jg, tg = _both("helical")
    for geo_mod, g in ((TD, tg), (JD, jg)):
        with pytest.raises(ValueError, match="divisible"):
            geo_mod.suggest_halo(g, 3)


@pytest.mark.parametrize("name", ["cone", "helical"])
def test_views_z_extent_matches_reference(name):
    jg, tg = _both(name)
    v = tg.v_coords()
    for idx, lo, hi in ((np.arange(tg.n_angles), float(v[0]) - 1.0,
                         float(v[-1]) + 1.0),
                        (np.arange(3, 11), float(v[1]), float(v[2]))):
        assert TD._views_z_extent(tg, idx, lo, hi) == \
            JD._views_z_extent(jg, idx, lo, hi)
    pj, pt = W.make_geom(jgeo, "par"), W.make_geom(tgeo, "par")
    for mod, g in ((TD, pt), (JD, pj)):
        with pytest.raises(ValueError, match="cone/modular"):
            mod._views_z_extent(g, np.arange(2), -1.0, 1.0)


def test_angle_chunks_match_reference():
    jg, tg = _both("cone")
    for n in (1, 2, 4):
        for a, b in zip(TD._angle_chunks(tg, n), JD._angle_chunks(jg, n)):
            assert a.to_config() == b.to_config()
    for mod, g in ((TD, tg.subset(np.arange(5))), (JD, jg.subset(np.arange(5)))):
        with pytest.raises(ValueError, match="divisible"):
            mod._angle_chunks(g, 2)


@pytest.mark.parametrize("name", ["cone", "helical"])
def test_chunk_geometries_match_reference(name):
    jg, tg = _both(name)
    for z, halo in ((2, 1), (4, 3)):
        for k in range(z):
            assert (dataclasses.asdict(TD._ext_slab_vol(tg.vol, z, k, halo))
                    == dataclasses.asdict(JD._ext_slab_vol(jg.vol, z, k, halo)))
            if name == "cone":
                assert (TD._row_block_geom(tg, z, k).to_config()
                        == JD._row_block_geom(jg, z, k).to_config())


def test_auto_comm_blocks_match_reference():
    jg = W.make_geom(jgeo, "cone")
    for per in range(1, 49):
        assert TD._auto_comm_blocks(per) == JD._auto_comm_blocks(per, jg, None)


def test_halo_collectives_validate_without_a_world():
    f = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="smaller than the local slab"):
        TD.halo_exchange_z(f, None, "model", 4)
    with pytest.raises(ValueError, match=">= 0"):
        TD.halo_exchange_z(f, None, "model", -1)
    with pytest.raises(ValueError, match="extended slab"):
        TD.halo_reduce_z(f, None, "model", 2)
    assert TD.halo_exchange_z(f, None, "model", 0) is f
    assert TD.halo_reduce_z(f, None, "model", 0) is f


LAYOUT_ERRORS = [
    ("par", ShardSpec(z_shards=2, halo=1), "exactly independent"),
    ("par", ShardSpec(z_shards=3), "vol.nz=8 must be divisible"),
    ("cone", ShardSpec(z_shards=2, halo=0), "too small"),
    ("cone", ShardSpec(z_shards=2, halo=4), "must be < nz_local"),
    # 77 voxels beyond a 64-slice slab; at 4 shards 52 < 128 is feasible
    ("cone_512_180", ShardSpec(z_shards=8, halo=60), "infeasible"),
]


@pytest.mark.parametrize("name,shard,match", LAYOUT_ERRORS,
                         ids=[m for *_, m in LAYOUT_ERRORS])
def test_layout_checks(name, shard, match):
    g = (table1_geometries()[name] if name == "cone_512_180"
         else W.make_geom(tgeo, name))
    with pytest.raises(ValueError, match=match):
        TD._validate_layout(ProjectorSpec(g, shard=shard))


def test_layout_checks_pass_the_card_cells():
    cells = table1_geometries()
    for g, shard in ((cells["parallel_512_180"], ShardSpec(angle_shards=2,
                                                           z_shards=2)),
                     (cells["cone_512_180"], ShardSpec(angle_shards=2,
                                                       z_shards=2, halo=1)),
                     (_long_helical(tgeo), ShardSpec(z_shards=4, halo=7))):
        TD._validate_layout(ProjectorSpec(g, shard=shard))


def test_launcher_names_the_failing_rank():
    with pytest.raises(RankError, match="rank 1 of 2.*rank one fails"):
        run_world(W.raise_on_rank_1, 2, backend="gloo", timeout=120)
    with pytest.raises(ValueError, match="backend"):
        run_world(W.raise_on_rank_1, 2, backend="mpi")


# --------------------------------------------------------------------------- #
# A (1, 1) world against the reference's (1, 1) mesh
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world11():
    return run_world(W.world_11, 1, backend="gloo", timeout=300)[0]


@pytest.fixture(scope="module")
def ref11():
    """The reference's DistributedProjector on a jax (1, 1) mesh, read with
    ``np.asarray`` (its ``jnp.vdot`` on a sharded array fails under the
    installed jax)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    g = W.make_geom(jgeo, "par_pair")
    dp = JD.distribute(JSpec(g), mesh, z_axis="model")
    x, y = W.data(g.vol.shape, 0), W.data(g.sino_shape, 1)
    errors = {}
    gp = g
    for key, call in (
            ("not_a_spec", lambda: JD.DistributedProjector(gp, mesh)),
            ("no_shard", lambda: JD.DistributedProjector(JSpec(gp), mesh)),
            ("mesh_axis", lambda: JD.DistributedProjector(JSpec(
                gp, shard=jspec.ShardSpec(("data", None), angle_shards=4)),
                mesh)),
            ("no_axis", lambda: JD.DistributedProjector(JSpec(
                gp, shard=jspec.ShardSpec(("rows", None))), mesh)),
            ("not_both", lambda: JD.distribute(JSpec(
                gp, shard=jspec.ShardSpec(("data", None))), mesh,
                z_axis="model")),
            ("not_divisible", lambda: JD.distribute(JSpec(
                gp.subset(np.arange(3))), mesh, comm_blocks=2))):
        try:
            call()
        except Exception as e:                  # noqa: BLE001 - compared below
            errors[key] = (type(e).__name__, str(e))
    return {"fp": np.asarray(dp(dp.shard_volume(x))),
            "bp": np.asarray(dp.T(dp.shard_sino(y))), "errors": errors}


def test_pair_on_11_mesh_matches_reference(world11, ref11):
    _vs(world11["pair"]["fp"], ref11["fp"])
    _vs(world11["pair"]["bp"], ref11["bp"], bp=True)
    assert world11["pair_dot"] < 1e-6
    assert world11["as_projector_passes"]
    assert "angle_shards=1, z_shards=1" in world11["pair_repr"]


def test_legacy_factory_matches_local_and_warns_once(world11):
    assert world11["legacy_warnings"] == ["DeprecationWarning"]
    np.testing.assert_allclose(*world11["legacy_fp"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(*world11["legacy_bp"], rtol=1e-5, atol=1e-5)
    kind, msg = world11["legacy_cone_z"]
    assert kind == "NotImplementedError" and "halo" in msg


@pytest.mark.parametrize("key", ["not_a_spec", "no_shard", "mesh_axis",
                                 "no_axis", "not_both", "not_divisible"])
def test_validation_errors_match_reference(world11, ref11, key):
    assert world11["errors"][key] == ref11["errors"][key]


def test_distributed_projector_defaults_to_cuda(world11):
    kind, msg = world11["errors"]["cpu_tensor_on_cuda_default"]
    assert kind == "RuntimeError" and 'device="cpu"' in msg


@pytest.mark.parametrize("solver", ["sirt", "cgls"])
def test_solver_bit_equal_on_11_mesh(world11, solver):
    assert world11[f"{solver}_bit_equal"]


def test_data_consistency_on_11_mesh(world11):
    a, b = world11["dc"]
    assert a == pytest.approx(b, rel=1e-6)


@pytest.mark.parametrize("what", ["fista_tv", "power_iteration",
                                  "data_consistency_refine",
                                  "complete_and_refine", "projection_residual"])
def test_other_solvers_bit_equal_on_11_mesh(world11, what):
    """FISTA-TV (with its power iteration), the power iteration, the
    refinement, complete-and-refine and the projection residual on a (1, 1)
    DistributedProjector: the bits of one device."""
    assert world11["solvers_bit_equal"][what]


# --------------------------------------------------------------------------- #
# A world of four ranks
# --------------------------------------------------------------------------- #
REF4 = r'''
import sys
import numpy as np
import jax
from repro.core import ProjectorSpec, VolumeGeometry, parallel_beam
from repro.core.distributed import distribute
d = np.load(sys.argv[1])
g = parallel_beam(16, 8, 32, VolumeGeometry(24, 24, 8))    # GEOMS["par"]
mesh = jax.make_mesh((2, 2), ("data", "model"))
dp = distribute(ProjectorSpec(g, backend="ref"), mesh, z_axis="model")
np.savez(sys.argv[2], fp=np.asarray(dp(dp.shard_volume(d["x"]))),
         bp=np.asarray(dp.T(dp.shard_sino(d["y"]))), halo=dp.shard.halo)
'''


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The port's 4-rank world, and beside it the reference's sharded
    parallel pair on 4 forced host devices in a subprocess of its own."""
    tmp = tmp_path_factory.mktemp("dist4")
    par_in = {"x": W.data((24, 24, 8), 10), "y": W.data((16, 8, 32), 11)}
    np.savez(tmp / "in.npz", **par_in)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", REF4, str(tmp / "in.npz"),
                            str(tmp / "ref.npz")], env=env, cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        out = run_world(W.world_4, 4, backend="gloo", timeout=600,
                        args=(par_in,))
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    return out, dict(np.load(tmp / "ref.npz"))


def test_mesh_layout(world4):
    ranks, _ = world4
    assert [r["mesh"]["coords22"] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                      (1, 1)]
    assert [r["mesh"]["coords14"] for r in ranks] == [(0, k) for k in range(4)]
    m = ranks[0]["mesh"]
    assert m["dp_tp22"] == (2, 2) and m["data_axes"] == ("data",)
    assert m["local"] == {"data": 2, "model": 2}
    assert m["bad_shape"][0] == "ValueError"


def test_halo_exchange_matches_numpy_oracle(world4):
    nz, shards, halo, nzl = 16, 4, 2, 4
    f = W.data((6, 6, nz), 0)
    out = world4[0][0]["halo_exchange"]
    assert out.shape == (6, 6, shards * (nzl + 2 * halo))
    padded = np.concatenate([np.zeros((6, 6, halo)), f,
                             np.zeros((6, 6, halo))], axis=2)
    for k in range(shards):
        got = out[:, :, k * (nzl + 2 * halo):(k + 1) * (nzl + 2 * halo)]
        want = padded[:, :, k * nzl:k * nzl + nzl + 2 * halo]
        np.testing.assert_array_equal(got, want, err_msg=f"shard {k}")


def test_halo_reduce_is_adjoint_of_exchange(world4):
    lhs, rhs = world4[0][0]["halo_adjoint"]
    # the reduce adds the halos in float32
    assert abs(lhs - rhs) / (abs(lhs) + 1e-12) < 1e-6


def test_parallel_22_matches_reference_sharded_pair(world4):
    ranks, ref = world4
    par = ranks[0]["par"]
    assert par["halo"] == int(ref["halo"]) == 0
    _vs(par["fp"], ref["fp"])
    _vs(par["bp"], ref["bp"], bp=True)
    g = W.make_geom(tgeo, "par")
    proj = Projector(ProjectorSpec(g), "cpu")
    _vs(par["fp"], proj(torch.from_numpy(W.data((24, 24, 8), 10))).numpy())
    _vs(par["bp"], proj.T(torch.from_numpy(W.data((16, 8, 32), 11))).numpy(),
        bp=True)
    assert par["dot"] < 1e-6
    kind, msg = ranks[0]["par_errors"]["halo_on_parallel"]
    assert kind == "ValueError" and "exactly independent" in msg


@pytest.mark.parametrize("name", ["cone", "helical"])
def test_sharded_pair_matches_local_ops(world4, name):
    """cone (2, 2) and helical (1, 4) against the reference's single-device
    ops and the port's."""
    got = world4[0][0][name]
    jg, tg = _both(name)
    assert got["halo"] == JD.suggest_halo(jg, 2 if name == "cone" else 4) >= 1
    for fp, bp in (_ref_local_pair(jg), _local_pair(tg)):
        _vs(got["fp"], fp)
        _vs(got["bp"], bp, bp=True)
    assert got["dot"] < 1e-6


def test_cone_undersized_halo_rejected(world4):
    kind, msg = world4[0][0]["cone"]["undersized"]
    assert kind == "ValueError" and "halo" in msg


def test_helical_sliding_z_capacity(world4):
    got = world4[0][0]["helical"]
    nz = W.GEOMS["helical"][2][2]
    nzl = got["local_vol"][2]
    assert nzl == nz // 4 and nzl + 2 * got["halo"] < nz


@pytest.mark.parametrize("cell", ["par", "helical"])
def test_overlap_comm_matches_psum(world4, cell):
    """The default one all-reduce against the overlap schedule's reduction
    per comm block (more than one block, so the blocks are exercised)."""
    got = world4[0][0][cell]
    assert got["comm_blocks"] > 1
    np.testing.assert_allclose(got["overlap"], got["psum"], rtol=1e-5,
                               atol=1e-5)


def test_helical_sirt_and_cgls_match_one_device(world4):
    ranks, _ = world4
    sol = ranks[0]["helical_solve"]
    hist = sol["sirt_hist"]
    assert hist[-1] < 0.25 * hist[0]
    for r in ranks[1:]:                     # every rank ran the same loop
        np.testing.assert_array_equal(r["helical_solve"]["sirt_hist"], hist)
    g = W.make_geom(tgeo, "helical")
    y = torch.from_numpy(sol["y"])
    ref = sirt(ProjectorSpec(g), y, n_iters=12)
    np.testing.assert_allclose(sol["sirt"], ref.image.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist, ref.residual_history.numpy(), rtol=1e-4)
    ref = cgls(ProjectorSpec(g), y, n_iters=10)
    np.testing.assert_allclose(sol["cgls"], ref.image.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(sol["cgls_hist"], ref.residual_history.numpy(),
                               rtol=1e-4)


def test_gradient_through_sharded_pair(world4):
    """d/dx 0.5 ||Ax - y||^2 = A^T(Ax - y) and d/dx <grad, v> = A^T A v on
    every rank of the cone (2, 2) layout."""
    for r in world4[0]:
        g = r["cone_grad"]
        assert g["grad_max_err"] <= 1e-6 * g["grad_scale"]
        assert g["hv_max_err"] <= 1e-6 * g["hv_scale"]


# --------------------------------------------------------------------------- #
# The solvers on (2, 2) DistributedProjectors
# --------------------------------------------------------------------------- #
SOLVE_TOL = 1e-5
# against the reference: tests/test_torch_solvers.py's bounds (the two
# packages' pairs agree to ~1e-6, which CG and FISTA amplify)
REF_IMG_TOL, REF_HIST_TOL = 5e-4, 5e-3


def _rel(got, want, what, tol=SOLVE_TOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())
    assert err <= tol, (what, err)


@pytest.mark.parametrize("name", ["par", "cone"])
def test_sharded_solvers_match_one_device(world4, name):
    """The port's solvers on the (2, 2) layout against the same solvers on
    the port's single-device Projector, on the gathered inputs."""
    got = world4[0][0][f"{name}_solve"]
    g = W.make_geom(tgeo, name)
    proj = Projector(ProjectorSpec(g), "cpu")
    inp = {k: torch.from_numpy(v) for k, v in W.solver_inputs(g).items()}
    y, x_net, mask = inp["y"], inp["x_net"], inp["mask"]
    it = W.SOLVER_ITERS
    L1 = float(power_iteration(proj, n_iters=it["power"])) * 1.05
    assert got["L"] == pytest.approx(L1, rel=SOLVE_TOL)
    res = fista_tv(proj, y, n_iters=it["fista"], L=got["L"])
    _rel(got["fista"], res.image, "fista_tv")
    _rel(got["fista_hist"], res.residual_history, "fista_tv history")
    res = fista_tv(proj, y, n_iters=it["fista_pi"])
    _rel(got["fista_pi"], res.image, "fista_tv, own power iteration")
    _rel(got["fista_pi_hist"], res.residual_history, "its history")
    _rel(got["dc"], data_consistency_refine(proj, x_net, y, mask,
                                            n_iters=it["dc"]), "refine")
    x, completed = complete_and_refine(proj, x_net, y, mask, n_iters=it["car"])
    _rel(got["car_x"], x, "complete_and_refine x")
    _rel(got["car_sino"], completed, "complete_and_refine sinogram")
    assert got["residual"] == pytest.approx(
        float(projection_residual(proj, x_net, y, mask)), rel=SOLVE_TOL)


@pytest.mark.parametrize("name", ["par", "cone"])
def test_sharded_solvers_match_reference_one_device(world4, name):
    """FISTA-TV (its ``L`` given) and the refinement on the (2, 2) layout
    against the reference's single-device solvers on the gathered
    problem, at ``tests/test_torch_solvers.py``'s bounds."""
    got = world4[0][0][f"{name}_solve"]
    g = W.make_geom(jgeo, name)
    inp = {k: jnp.asarray(v) for k, v in W.solver_inputs(g).items()}
    it = W.SOLVER_ITERS
    res = jrecon.fista_tv(JSpec(g), inp["y"], n_iters=it["fista"], L=got["L"])
    _rel(got["fista"], res.image, "fista_tv", REF_IMG_TOL)
    _rel(got["fista_hist"], res.residual_history, "fista_tv history",
         REF_HIST_TOL)
    _rel(got["dc"], jrecon.data_consistency_refine(
        JSpec(g), inp["x_net"], inp["y"], inp["mask"], n_iters=it["dc"]),
        "refine", REF_IMG_TOL)
