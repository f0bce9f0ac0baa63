"""LM training through the port (``launch/steps.make_train_step``,
``launch/train.{build,train_loop,main}``, remat in ``models/model.py``)
against the reference package, on the CPU, at the Qwen3-0.6B smoke config.

* ``make_train_step`` against the reference's (``jax.jit``), two steps from
  the same parameters (``params_from_jax``) on the same token batches: as
  written, with ``grad_accum=2``, and with 1-bit compression (the
  reference's residual carried out of its jitted step).  Loss and gradient
  norm within ``tests/test_torch_models.py``'s bf16 bound (3e-2); the
  parameters' change from their start against the reference's change, in
  norm, as a whole and leaf by leaf (``_assert_updates``).
* ``abstract_params`` against the reference's for every config.
* Remat ``"none"``, ``"full"`` and ``"dots"``: bit-equal loss and
  gradients, on the dense-attention and the flash branch.
* ``train_loop`` against the reference's ``make_train_step`` driven over
  the same pipeline batches from the port's initial parameters (the
  reference's own ``train_loop`` is one of its known failures: its
  ``launch/sharding.make_ac`` is refused by the installed jax); a failure
  under ``Supervisor`` resumes to the uninterrupted run's losses and
  parameters, bit for bit on one thread; two gloo ranks of data
  parallelism against one process on the global batch (f32: the first
  loss, gradients and losses within 1e-6, the parameters within AdamW's
  bound of 2 x steps x lr, as ``tests/test_torch_dp_train.py``); ``main``
  in-process; the example on the CPU.
"""
import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.launch import steps as JS
from repro.models import model as JMD
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.runtime import compression as jcomp

from repro_torch import configs as tconfigs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import run_world
from repro_torch.models import model as TMD
from repro_torch.runtime import checkpoint as CKPT
from repro_torch.runtime import compression as tcomp
from repro_torch.runtime.fault import Supervisor

import torch_dist_worlds as W

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen3_0_6b"
BF16_REL_TO_MAX = 3e-2          # tests/test_torch_models.py
UPDATE_REL_TOL, UPDATE_LEAF_REL_TOL = 0.15, 0.3     # see _assert_updates
LR, TOTAL = 3e-4, 10            # warmup over min(100, 10 // 10 + 1) = 2 steps
SEQ, BATCH = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    """The reference's initial parameters of the smoke config (numpy)."""
    return jax.tree.map(np.asarray, JMD.init_params(jconfigs.get_smoke(ARCH),
                                                    jax.random.PRNGKey(0)))


def _assert_updates(tp, tp0, jp, jp0, what):
    """The port's parameter change ``tp - tp0`` against the reference's
    ``jp - jp0``: ``||d_port - d_ref|| / ||d_ref||`` at most
    ``UPDATE_REL_TOL`` over all leaves and ``UPDATE_LEAF_REL_TOL`` on each,
    with every leaf's ``d_ref`` nonzero.  The first AdamW steps move each
    entry by about ``lr * sign(g)``, so the two sides differ where bf16
    noise flips the sign of a gradient entry near zero; the readings were
    at most 0.103 over all leaves and 0.190 on one (``layers/attn/q_norm``
    under compression).  A step that updates nothing reads 1, one of the
    wrong sign 2."""
    want = dict(TMD._leaves(jax.tree.map(np.asarray, jp)))
    want0 = dict(TMD._leaves(jax.tree.map(np.asarray, jp0)))
    start = dict(TMD._leaves(tp0))
    num = den = 0.0
    for path, t in TMD._leaves(tp):
        d_port = (t.detach().double() - start[path].double()).numpy()
        d_ref = want[path].astype(np.float64) - want0[path].astype(np.float64)
        err, ref = np.sum((d_port - d_ref) ** 2), np.sum(d_ref ** 2)
        assert ref > 0, (what, "/".join(path), "the reference did not move")
        rel = float(np.sqrt(err / ref))
        assert rel <= UPDATE_LEAF_REL_TOL, (what, "/".join(path), rel)
        num, den = num + err, den + ref
    rel = float(np.sqrt(num / den))
    assert rel <= UPDATE_REL_TOL, (what, rel)


def _batches(cfg, n):
    pipe = TokenPipeline(cfg.vocab_size, SEQ, BATCH)
    return [pipe.batch(i) for i in range(n)]


VARIANTS = {"plain": {}, "grad_accum": {"grad_accum": 2},
            "compress": {"compress": True}}


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_matches_reference(jparams, variant):
    kw = dict(VARIANTS[variant])
    compress = kw.pop("compress", False)
    tcfg, jcfg = tconfigs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    opt, _ = TT.build(tcfg, None, lr=LR, total_steps=TOTAL)
    jopt = jadamw(jwarmup_cosine(LR, min(100, TOTAL // 10 + 1), TOTAL),
                  weight_decay=0.1)
    tp = TMD.params_from_jax(jparams, tcfg, device="cpu")
    tp0 = TMD.unflatten({k: v.clone() for k, v in TMD.flatten(tp).items()})
    jp = jax.tree.map(jnp.asarray, jparams)
    tstate, jstate = opt.init(TMD.flatten(tp)), jopt.init(jp)
    tres, jres = (tcomp.init_state(TMD.flatten(tp)), jcomp.init_state(jp))

    def tcompress(g):
        nonlocal tres
        q, tres = tcomp.compress(g, tres)
        return q

    def jstep(p, s, batch, res):
        box = {}

        def cf(g):
            q, box["res"] = jcomp.compress(g, res)
            return q

        p, s, m = JS.make_train_step(jcfg, jopt, compress_fn=cf if compress
                                     else None, **kw)(p, s, batch)
        return p, s, m, box.get("res", res)

    tstep = TS.make_train_step(tcfg, opt, compress_fn=tcompress if compress
                               else None, **kw)
    jstep = jax.jit(jstep)
    for i, toks in enumerate(_batches(tcfg, 2)):
        tp, tstate, tm = tstep(tp, tstate, {"tokens": torch.from_numpy(toks)})
        jp, jstate, jm, jres = jstep(jp, jstate, {"tokens": jnp.asarray(toks)},
                                     jres)
        for name in ("loss", "grad_norm"):
            got, want = float(tm[name]), float(jm[name])
            assert abs(got - want) <= BF16_REL_TO_MAX * abs(want), (i, name)
        _assert_updates(tp, tp0, jp, jparams, f"step {i}")
    assert int(tstate.step) == int(jstate.step) == 2


def test_grad_accum_sums_microbatches_and_reports_the_last_loss():
    """``grad_accum=2`` against two separate gradients of the halves:
    the sum ``g / 2`` in microbatch order, bit for bit, and the second
    half's loss (the reference's ``metrics["loss"]``)."""
    cfg = tconfigs.get_smoke(ARCH)
    p = TMD.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_batches(cfg, 1)[0])
    seen = {}

    def capture(g):
        seen.update(g)
        return g

    opt, _ = TT.build(cfg, None)
    _, _, m = TS.make_train_step(cfg, opt, grad_accum=2, compress_fn=capture)(
        p, opt.init(TMD.flatten(p)), {"tokens": toks})
    l0, g0 = TS.value_and_grad(cfg, p, {"tokens": toks[:2]})
    l1, g1 = TS.value_and_grad(cfg, p, {"tokens": toks[2:]})
    assert torch.equal(m["loss"], l1)
    for k in g0:
        assert torch.equal(seen[k], g0[k] / 2 + g1[k] / 2), k
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_train_step(cfg, opt, grad_accum=3)(
            p, opt.init(TMD.flatten(p)), {"tokens": toks})


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_abstract_params_match_reference(arch):
    mine = dict(TMD._leaves(TMD.abstract_params(tconfigs.get(arch))))
    ref = dict(TMD._leaves(JMD.abstract_params(jconfigs.get(arch))))
    assert set(mine) == set(ref)
    for path, t in mine.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[path].shape), path
        assert str(t.dtype).split(".")[-1] == str(ref[path].dtype), path


@functools.lru_cache(maxsize=None)
def _loss_and_grads(policy: str, S: int):
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCH), remat_policy=policy,
                              n_layers=2 if S <= 2048 else 1)
    p = TMD.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2 if S <= 2048 else 1, S)).astype(np.int32))
    return TS.value_and_grad(cfg, p, {"tokens": toks})


@pytest.mark.parametrize("S", [64, 3072])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_are_bit_equal(policy, S):
    """S = 64: the dense masked softmax; S = 3072: the flash branch (its
    plain version on CPU tensors)."""
    loss, grads = _loss_and_grads(policy, S)
    want_loss, want = _loss_and_grads("none", S)
    assert torch.equal(loss, want_loss)
    for k, g in grads.items():
        assert torch.equal(g, want[k]), k


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCH), remat_policy="some")
    p = TMD.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat_policy"):
        TS.value_and_grad(cfg, p, {"tokens": torch.zeros((1, 8),
                                                         dtype=torch.int64)})


def test_train_loop_matches_reference_steps():
    """train_loop's losses and parameter change against the reference's
    jitted make_train_step (build's optimizer over the run's steps) over
    the same pipeline batches, from train_loop's initial parameters carried
    to the reference (readings: 0.076 over all leaves, 0.119 on one)."""
    tcfg, jcfg = tconfigs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    steps = 3
    params, losses = TT.train_loop(tcfg, None, TokenPipeline(tcfg.vocab_size,
                                                             SEQ, BATCH),
                                   steps, log_every=0, device="cpu", lr=LR)
    p0 = TMD.init_params(tcfg, torch.Generator(device="cpu").manual_seed(0))
    jp = jp0 = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p0)
    # train_loop's schedule spans its run's steps
    jopt = jadamw(jwarmup_cosine(LR, min(100, steps // 10 + 1), steps),
                  weight_decay=0.1)
    jstate = jopt.init(jp)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    pipe = JTokenPipeline(jcfg.vocab_size, SEQ, BATCH)
    want = []
    for i in range(steps):
        jp, jstate, m = jstep(jp, jstate, {"tokens": jnp.asarray(pipe.batch(i))})
        want.append(float(m["loss"]))
    assert len(losses) == steps
    for got, w in zip(losses, want):
        assert abs(got - w) <= BF16_REL_TO_MAX * abs(w), (losses, want)
    _assert_updates(params, p0, jp, jp0, "final")


def test_supervisor_resume_reproduces_uninterrupted(tmp_path):
    """A failure before step 3 of 6 with a checkpoint every 2 steps: the
    Supervisor's second attempt resumes at step 2 and runs steps 2-5 to the
    uninterrupted run's losses and parameters, bit for bit (one thread:
    torch's multi-threaded CPU kernels may sum in a run-dependent order)."""
    cfg = tconfigs.get_smoke(ARCH)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want_p, want = TT.train_loop(cfg, None, TokenPipeline(
            cfg.vocab_size, SEQ, BATCH), 6, log_every=0, device="cpu")
        pipe = TokenPipeline(cfg.vocab_size, SEQ, BATCH)
        starts, runs = [], []

        def loop(start):
            starts.append(start)
            runs.append(TT.train_loop(
                cfg, None, pipe, 6, str(tmp_path), ckpt_every=2, log_every=0,
                fail_at_step=3 if len(starts) == 1 else None, device="cpu"))
            return 6

        sup = Supervisor(loop, lambda: CKPT.latest_step(str(tmp_path)) or 0,
                         max_restarts=2, backoff_s=0.0)
        assert sup.run() == 6
    finally:
        torch.set_num_threads(n)
    assert starts == [0, 2] and sup.restarts == 1 and len(runs) == 1
    params, losses = runs[0]
    assert losses == want[2:]
    for k, t in TMD.flatten(params).items():
        assert torch.equal(t, TMD.flatten(want_p)[k]), k
    assert CKPT.latest_step(str(tmp_path)) == 6 and pipe.step == 6


class _GlobalPipeline:
    """The global batch of a 2-rank data-parallel world: each rank's rows
    (``TokenPipeline(shard_index=r, shard_count=2)``) in rank order."""

    def __init__(self, cfg):
        self.parts = [TokenPipeline(cfg.vocab_size, W.LM_DP["seq"],
                                    W.LM_DP["batch"], shard_index=r,
                                    shard_count=2) for r in range(2)]
        self.step = 0

    def batch(self, step):
        return np.concatenate([p.batch(step) for p in self.parts])


@pytest.fixture(scope="module")
def lm_dp():
    ranks = run_world(W.world_lm_dp, 2, backend="gloo", timeout=300)
    one = W.lm_dp_run(None, _GlobalPipeline(W.lm_dp_cfg()))
    return ranks, one


def test_data_parallel_matches_one_process(lm_dp):
    ranks, one = lm_dp
    bound = 2 * W.LM_DP["steps"] * 3e-4            # train_loop's peak lr
    for r in ranks:
        assert r["loss0"] == pytest.approx(one["loss0"], rel=1e-6)
        a = np.concatenate([r["grads0"][k].ravel() for k in one["grads0"]])
        b = np.concatenate([one["grads0"][k].ravel() for k in one["grads0"]])
        assert np.linalg.norm(a - b) <= 1e-6 * np.linalg.norm(b)
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-6)
        for k, v in one["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=0, atol=bound,
                                       err_msg=k)
    a, b = (r["params"] for r in ranks)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_data_parallel_refusals(lm_dp):
    kind, msg = lm_dp[0][0]["unsharded_pipeline"]
    assert kind == "ValueError" and "shard_index" in msg
    # a model axis of 2 trains, and as one process does on the same batches
    cfg = W.lm_dp_cfg()
    _, want = TT.train_loop(cfg, None, TokenPipeline(cfg.vocab_size, W.LM_DP["seq"],
                                                     W.LM_DP["batch"]),
                            W.LM_DP["steps"], device="cpu", log_every=0)
    for r in lm_dp[0]:
        np.testing.assert_allclose(r["model_axis"], want, rtol=1e-5)


def test_main_runs_smoke_in_process(tmp_path, capsys):
    TT.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "3", "--device",
             "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0" in out and out.rstrip().endswith("done.")
    assert CKPT.latest_step(str(tmp_path)) == 3
    for flag, n in (("--production-mesh", 256), ("--multi-pod", 512)):
        with pytest.raises(ValueError, match=f"world of {n} ranks; this world has 1"):
            TT.main(["--arch", "qwen3-0.6b", "--smoke", flag])
    losses = TT.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "2",
                      "--device", "cpu", "--world", "2", "--model-axis", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_example_runs_on_the_host():
    path = ROOT / "examples" / "lm_train_serve_torch.py"
    spec = importlib.util.spec_from_file_location("lm_train_serve_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses, tokens = mod.main(["--device", "cpu", "--steps", "3"])
    cfg = tconfigs.get_smoke(ARCH)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert len(tokens) == 16 and all(0 <= t < cfg.vocab_size for t in tokens)
