"""The port's CT serving subsystem (``repro_torch.launch.ct_serve``) on the
host: each case of ``tests/test_ct_serve.py`` on ``CTServer(device="cpu")``,
and the reference's ``CTServer`` and the port's on the same numpy
sinograms.

Tolerances, as ``tests/test_torch_recon.py`` and ``test_torch_solvers.py``
hold the solvers: FBP and SIRT images within 1e-4 of the largest value
(SIRT histories 1e-4 relative); CGLS and FISTA-TV images 5e-4 relative L2
and histories 5e-3, since CG-type iterations amplify the pairs' ~1e-6
difference.  FISTA-TV gets one Lipschitz constant in both servers: the
packages draw ``power_iteration``'s start differently."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.launch import ct_serve as jserve

import repro_torch.core.geometry as tgeo
from repro_torch import Projector, ProjectorSpec
from repro_torch.kernels import build, ops, tune
from repro_torch.launch.ct_serve import (CTServer, ReconRequest, TIERS,
                                         TIER_SOLVERS, _size_class,
                                         solver_tier)
from repro_torch.recon import cgls, power_iteration, sirt


@pytest.fixture(autouse=True)
def _isolated_tune_cache(tmp_path, monkeypatch):
    """The port's tune cache in this test's own directory."""
    monkeypatch.setenv(tune.CACHE_PATH_ENV, str(tmp_path / "tune.json"))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to two threads: the suite runs in several worker
    processes, and oversubscribed OpenMP threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _geoms(G):
    vol = G.VolumeGeometry(16, 16, 1)
    return {"par": G.parallel_beam(12, 1, 24, vol),
            "fan": G.fan_beam(12, 1, 24, vol, sod=60.0, sdd=120.0)}


@pytest.fixture(scope="module")
def world():
    """Both packages' specs and the phantom's sinograms (numpy, from the
    reference's projector) of the 16x16x1 parallel and fan geometries."""
    f = np.zeros((16, 16, 1), np.float32)
    f[5:11, 5:11, :] = 0.02
    f[3:6, 9:14, :] = 0.03
    out = {}
    for name, jg in _geoms(jcore).items():
        js = jcore.ProjectorSpec(jg)
        ts = ProjectorSpec(_geoms(tgeo)[name])
        out[name] = (js, ts, np.array(jcore.Projector(js)(jnp.asarray(f))))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_solver_tiers():
    assert solver_tier("fbp") == "interactive"
    for s in TIER_SOLVERS["quality"]:
        assert solver_tier(s) == "quality"
    with pytest.raises(ValueError):
        solver_tier("mystery")
    assert TIERS == jserve.TIERS and TIER_SOLVERS == jserve.TIER_SOLVERS


def test_size_classes():
    assert [_size_class(n, 16) for n in (1, 2, 3, 5, 16, 40)] == \
        [1, 2, 4, 8, 16, 16]
    assert _size_class(7, 4) == 4
    assert all(_size_class(n, m) == jserve._size_class(n, m)
               for n in range(1, 40) for m in (1, 3, 4, 16))


def test_server_needs_the_card_unless_asked_for_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        CTServer()
    with pytest.raises(ValueError):
        CTServer(max_batch=0, device="cpu")
    assert CTServer(device="cpu").device == torch.device("cpu")


def test_batched_matches_per_request(world):
    """A packed batch answers bit-identically to what the solver produces
    on each request alone."""
    _, spec, y = world["par"]
    srv = CTServer(max_batch=8, device="cpu")
    rids = [srv.submit(ReconRequest(spec=spec, sino=(i + 1) * y,
                                    solver="sirt",
                                    solver_kwargs={"n_iters": 5}))
            for i in range(5)]
    done = srv.drain()
    assert len(srv.dispatch_log) == 1
    rec = srv.dispatch_log[0]
    assert rec["size_class"] == 8 and sorted(rec["rids"]) == sorted(rids)
    for i, rid in enumerate(rids):
        resp = done[rid]
        assert resp.ok and resp.batch_size == 5
        assert resp.image.device.type == "cpu"
        direct = sirt(spec, torch.from_numpy((i + 1) * y), n_iters=5)
        np.testing.assert_allclose(resp.image.numpy(), direct.image.numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(resp.result.residual_history.numpy(),
                                   direct.residual_history.numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_heterogeneous_specs_never_share_a_batch(world):
    """Requests with different geometry content, or the same geometry but
    different solver kwargs, land in separate packed dispatches."""
    (_, s_par, y_par), (_, s_fan, y_fan) = world["par"], world["fan"]
    srv = CTServer(max_batch=16, device="cpu")
    kinds = {}
    for i in range(12):
        if i % 3 == 0:
            r = ReconRequest(spec=s_par, sino=y_par, solver="fbp")
        elif i % 3 == 1:
            r = ReconRequest(spec=s_fan, sino=y_fan, solver="fbp")
        else:
            r = ReconRequest(spec=s_par, sino=y_par, solver="fbp",
                             solver_kwargs={"filter_name": "hann"})
        kinds[srv.submit(r)] = i % 3
    done = srv.drain()
    assert all(done[r].ok for r in kinds)
    assert len(srv.dispatch_log) == 3
    for rec in srv.dispatch_log:
        assert len({kinds[r] for r in rec["rids"]}) == 1, \
            "heterogeneous requests packed into one batch"


def test_tier_priority(world):
    """Interactive requests are dispatched before quality requests even
    when the quality queue is older; within a tier the oldest goes first."""
    (_, spec, y), (_, s_fan, y_fan) = world["par"], world["fan"]
    srv = CTServer(max_batch=8, device="cpu")
    q = srv.submit(ReconRequest(spec=spec, sino=y, solver="sirt",
                                solver_kwargs={"n_iters": 3}))
    q2 = srv.submit(ReconRequest(spec=s_fan, sino=y_fan, solver="cgls",
                                 solver_kwargs={"n_iters": 3}))
    i = srv.submit(ReconRequest(spec=spec, sino=y, solver="fbp"))
    assert srv.pending() == 3
    done = srv.drain()
    assert srv.pending() == 0
    assert done[q].ok and done[q2].ok and done[i].ok
    assert [rec["tier"] for rec in srv.dispatch_log] == \
        ["interactive", "quality", "quality"]
    assert [rec["rids"] for rec in srv.dispatch_log] == [[i], [q], [q2]]
    assert srv.take_responses().keys() == {q, q2, i}
    assert srv.take_responses() == {}


def test_submit_validation_is_isolated(world):
    _, spec, y = world["par"]
    srv = CTServer(max_batch=4, device="cpu")
    good = srv.submit(ReconRequest(spec=spec, sino=y, solver="fbp"))
    bad_shape = srv.submit(ReconRequest(spec=spec, sino=np.zeros((2, 2, 2)),
                                        solver="fbp"))
    bad_solver = srv.submit(ReconRequest(spec=spec, sino=y, solver="magic"))
    bad_spec = srv.submit(ReconRequest(spec=world["par"][0], sino=y,
                                       solver="fbp"))
    done = srv.drain()
    assert done[good].ok
    assert not done[bad_shape].ok and "shape" in done[bad_shape].error
    assert not done[bad_solver].ok and "solver" in done[bad_solver].error
    assert not done[bad_spec].ok and "ProjectorSpec" in done[bad_spec].error
    # invalid requests never reached a packed batch
    dispatched = {r for rec in srv.dispatch_log for r in rec["rids"]}
    assert dispatched == {good}


def test_executor_failure_isolates_poisoned_request(world):
    """When a packed dispatch fails, batch mates are re-run individually:
    only the poisoned request is answered with an error."""
    _, spec, y = world["par"]
    srv = CTServer(max_batch=4, device="cpu")
    srv.warm(spec, "fbp", batch_sizes=(1, 4))
    key = srv.bucket_key(ReconRequest(spec=spec, sino=y, solver="fbp"))
    real_single = srv._executor(key, 1)

    def exploding_batch(batch):
        raise RuntimeError("batch executor blew up")

    def picky_single(batch):
        if float(batch.sum()) < 0:
            raise RuntimeError("poisoned request")
        return real_single(batch)

    srv._executors[(key, 4)] = exploding_batch
    srv._executors[(key, 1)] = picky_single

    good = [srv.submit(ReconRequest(spec=spec, sino=y, solver="fbp"))
            for _ in range(3)]
    poisoned = srv.submit(ReconRequest(spec=spec, sino=-np.abs(y),
                                       solver="fbp"))
    done = srv.drain()
    expect = Projector(spec, device="cpu").fbp(torch.from_numpy(y)).numpy()
    for rid in good:
        assert done[rid].ok, done[rid].error
        np.testing.assert_allclose(done[rid].image.numpy(), expect,
                                   rtol=1e-5, atol=1e-7)
    assert not done[poisoned].ok
    assert "poisoned" in done[poisoned].error
    assert srv.dispatch_log[0]["size_class"] == 4


def test_warm_server_compiles_nothing_on_request_path(world, monkeypatch):
    """The warm-path guarantee: after warm(), traffic across every batch
    size class triggers no autotune sweep, no op-cache miss or entry, no
    new executor and no library load (with the tune disk cache on)."""
    monkeypatch.setenv(tune.CACHE_ENV, "1")
    (_, s_par, y_par), (_, s_fan, y_fan) = world["par"], world["fan"]
    srv = CTServer(max_batch=4, device="cpu")
    srv.warm(s_par, "fbp")
    srv.warm(s_fan, "fbp")
    srv.warm(s_par, "sirt", {"n_iters": 3})
    srv.warm(s_fan, "fista_tv", {"n_iters": 2})

    sweeps0 = tune.sweep_count()
    stats0 = ops.cache_stats()
    executors0 = set(srv._executors)
    loaded0 = build.loaded()

    rids = []
    for n in (1, 2, 3, 4, 4):          # every size class, twice the largest
        for _ in range(n):
            rids.append(srv.submit(
                ReconRequest(spec=s_par, sino=y_par, solver="fbp")))
        srv.drain()
    rids.append(srv.submit(ReconRequest(spec=s_fan, sino=y_fan,
                                        solver="fbp")))
    for _ in range(3):
        rids.append(srv.submit(ReconRequest(spec=s_par, sino=y_par,
                                            solver="sirt",
                                            solver_kwargs={"n_iters": 3})))
    rids.append(srv.submit(ReconRequest(spec=s_fan, sino=y_fan,
                                        solver="fista_tv",
                                        solver_kwargs={"n_iters": 2})))
    done = srv.drain()
    assert all(done[r].ok for r in rids)

    assert tune.sweep_count() == sweeps0, "autotune swept on the request path"
    stats1 = ops.cache_stats()
    assert stats1["size"] == stats0["size"], "new op-cache entry built"
    assert stats1["misses"] == stats0["misses"], "op-cache miss on request path"
    assert set(srv._executors) == executors0, "new executor built"
    assert build.loaded() == loaded0, "kernel library loaded on request path"


def test_fista_lipschitz_once_a_bucket(world, monkeypatch):
    """FISTA-TV's L is computed once a bucket, when its first executor is
    built, and reused by every size class."""
    _, spec, _ = world["fan"]
    from repro_torch.launch import ct_serve
    calls = []
    orig = ct_serve.power_iteration

    def counting(proj, *a, **kw):
        calls.append(proj)
        return orig(proj, *a, **kw)

    monkeypatch.setattr(ct_serve, "power_iteration", counting)
    srv = CTServer(max_batch=4, device="cpu")
    srv.warm(spec, "fista_tv", {"n_iters": 1})
    assert len(calls) == 1 and len(srv._executors) == 3
    srv.warm(spec, "fista_tv", {"n_iters": 1, "L": 2.0})   # L given: none
    assert len(calls) == 1


def test_sinograms_on_the_device_pack_as_numpy_ones(world):
    """Tensors already on the server's device are stacked there; numpy
    sinograms go through one host stack; both answer the same."""
    _, spec, y = world["par"]
    answers = []
    for wrap in (np.asarray, torch.from_numpy):
        srv = CTServer(max_batch=4, device="cpu")
        rids = [srv.submit(ReconRequest(spec=spec, sino=wrap((i + 1) * y),
                                        solver="cgls",
                                        solver_kwargs={"n_iters": 3}))
                for i in range(3)]
        done = srv.drain()
        answers.append([done[r].image.numpy() for r in rids])
    for a, b in zip(*answers):
        np.testing.assert_array_equal(a, b)


def test_device_packs_are_float32(world):
    """bf16 sinograms already on the server's device are packed as float32,
    as numpy ones are: the same answers, in float32."""
    _, spec, y = world["par"]
    sinos = [torch.from_numpy((i + 1) * y).to(torch.bfloat16) for i in range(3)]
    answers = []
    for wrap in (lambda t: t, lambda t: t.float().numpy()):
        srv = CTServer(max_batch=4, device="cpu")
        rids = [srv.submit(ReconRequest(spec=spec, sino=wrap(s), solver="sirt",
                                        solver_kwargs={"n_iters": 3}))
                for s in sinos]
        done = srv.drain()
        answers.append([done[r].image for r in rids])
    for a, b in zip(*answers):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


def test_cgls_gives_a_packed_sample_its_bits_alone(world):
    """CGLS reduces its inner products one sample at a time: a sample of a
    packed batch gets the image and residual history it gets alone."""
    _, spec, y = world["fan"]
    ys = torch.from_numpy(np.stack([(i + 1) * y for i in range(3)]))
    packed = cgls(spec, ys, n_iters=5)
    for i in range(3):
        one = cgls(spec, ys[i], n_iters=5)
        assert torch.equal(packed.image[i], one.image)
        assert torch.equal(packed.residual_history[i], one.residual_history)


@pytest.mark.parametrize("solver,kwargs,geom", [
    ("fbp", {}, "par"), ("fbp", {"filter_name": "hann"}, "fan"),
    ("sirt", {"n_iters": 5}, "par"), ("cgls", {"n_iters": 5}, "fan"),
    ("fista_tv", {"n_iters": 5}, "par")])
def test_matches_the_reference_server(world, solver, kwargs, geom):
    """The same three numpy sinograms through the reference's CTServer and
    the port's: the same dispatches, images and residual histories."""
    js, ts, y = world[geom]
    if solver == "fista_tv":
        kwargs = dict(kwargs, L=float(power_iteration(
            Projector(ts, device="cpu"))) * 1.05)
    sinos = [(i + 1) * y for i in range(3)]
    jsrv, tsrv = jserve.CTServer(max_batch=4), CTServer(max_batch=4,
                                                        device="cpu")
    jr = [jsrv.submit(jserve.ReconRequest(spec=js, sino=jnp.asarray(s),
                                          solver=solver,
                                          solver_kwargs=dict(kwargs)))
          for s in sinos]
    tr = [tsrv.submit(ReconRequest(spec=ts, sino=s, solver=solver,
                                   solver_kwargs=dict(kwargs)))
          for s in sinos]
    jdone, tdone = jsrv.drain(), tsrv.drain()
    assert [(d["tier"], d["solver"], d["size_class"], d["rids"])
            for d in tsrv.dispatch_log] == \
        [(d["tier"], d["solver"], d["size_class"], d["rids"])
         for d in jsrv.dispatch_log]
    for a, b in zip(jr, tr):
        want, got = jdone[a], tdone[b]
        assert got.ok and want.ok and got.batch_size == want.batch_size == 3
        wi, gi = np.asarray(want.image), got.image.numpy()
        wh = np.asarray(want.result.residual_history)
        gh = got.result.residual_history.numpy()
        assert gh.shape == wh.shape
        assert got.result.iterations == want.result.iterations
        if solver in ("fbp", "sirt"):
            np.testing.assert_allclose(gi, wi, rtol=0,
                                       atol=1e-4 * np.abs(wi).max())
            np.testing.assert_allclose(gh, wh, rtol=1e-4)
        else:
            assert _rel(gi, wi) < 5e-4
            assert _rel(gh, wh) < 5e-3


def test_serial_server_is_the_solver_alone(world):
    """max_batch=1 dispatches each request alone, one record each."""
    _, spec, y = world["fan"]
    srv = CTServer(max_batch=1, device="cpu")
    rids = [srv.submit(ReconRequest(spec=spec, sino=(i + 1) * y,
                                    solver="cgls",
                                    solver_kwargs={"n_iters": 4}))
            for i in range(3)]
    done = srv.drain()
    assert [rec["rids"] for rec in srv.dispatch_log] == [[r] for r in rids]
    for i, rid in enumerate(rids):
        want = cgls(spec, torch.from_numpy((i + 1) * y)[None], n_iters=4)
        np.testing.assert_array_equal(done[rid].image.numpy(),
                                      want.image[0].numpy())
        assert done[rid].batch_size == 1 and done[rid].latency_s > 0
