"""Tensor, FSDP and TP x DP parallelism of the port's LM
(``launch/sharding.py``) on gloo worlds of the CPU, against one device and
the reference package.

Every world (``tests/torch_dist_worlds.py``) runs once in a module
fixture.  The configs are the ten smoke configs in f32 (the layouts sum
in different orders; in f32 they agree to ~1e-6 of the largest entry),
plus a Hymba whose 3 heads and vocabulary of 513 do not split two ways
(its attention and vocabulary replicated beside its split Mamba branch
and MLP).

* (1, 2): each config's loss and every gradient, gathered to the global
  layout, against one device at 1e-5 (the loss relative, each gradient
  leaf relative to its largest entry), and the loss against the
  reference's ``loss_fn`` on the same weights at ``test_torch_families``'
  f32 tolerance;
* (1, 4): the same where ``wq`` splits but ``wk`` does not (each rank
  computes the KV heads its query heads read) and where no head splits;
* sequence parallelism (``seq_shard``: the three configs that set it, and
  four that do not, set here) in every world, and its collectives in
  ``record`` mode;
* (2, 1) with ``fsdp=True``, (2, 2), and (2, 1, 2) ``("pod", "data",
  "model")`` with ``fsdp=True``: the same, the data axes averaged;
* (2, 2): three ``train_loop`` steps with clipping and 1-bit compression
  against one device on the same global batches, and a 5-step run that
  writes a checkpoint at step 3 and fails there, resumed on a (1, 1) mesh
  to step 5 against one device's uninterrupted run (losses within 1e-5, parameters within
  AdamW's bound of 2 x steps x lr);
* a ``Server`` on (1, 2), on (1, 4) (KV heads that do not split four
  ways), and on (2, 2) with its slots split over the data axis: the
  tokens equal one device's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JMD

from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import run_world
from repro_torch.models import model as TMD

import torch_dist_worlds as W
from test_torch_models import BF16, BF16_REL_TO_MAX, F32

ARCHS = tconfigs.ARCHS
DEGRADE = ("hymba_1_5b", dict(n_heads=3, n_kv_heads=1, vocab_size=513))
# the three published seq_shard configs run sequence parallelism as they
# are; these add it where a Mamba branch, a MoE layer, codebooks and a
# replicated attention and vocabulary meet it
SEQ = {"hymba_degrade_sp": ("hymba_1_5b", dict(DEGRADE[1], seq_shard=True)),
       "falcon_mamba_sp": ("falcon_mamba_7b", dict(seq_shard=True)),
       "olmoe_sp": ("olmoe_1b_7b", dict(seq_shard=True)),
       "musicgen_sp": ("musicgen_large", dict(seq_shard=True))}
CASES = {**{a: (a, {}) for a in ARCHS}, "hymba_degrade": DEGRADE, **SEQ}
# at tp = 4: wq splits and wk does not (4/2, 8/2 heads; Nemotron's and
# Grok's under sequence parallelism), or no head splits
CASES_TP4 = {a: (a, {}) for a in ("qwen3_0_6b", "hymba_1_5b", "nemotron_4_340b",
                                  "grok_1_314b", "olmoe_1b_7b", "musicgen_large")}
SERVE_ARCHS = ["qwen3_0_6b", "hymba_1_5b", "falcon_mamba_7b", "musicgen_large",
               "olmoe_1b_7b"]
TOL = 1e-5


@pytest.fixture(scope="module")
def tp12():
    return run_world(W.world_tp, 2, backend="gloo", timeout=300,
                     args=((1, 2), CASES))


@pytest.fixture(scope="module")
def tp14():
    return run_world(W.world_tp, 4, backend="gloo", timeout=300,
                     args=((1, 4), CASES_TP4))


@pytest.fixture(scope="module")
def fsdp21():
    return run_world(W.world_tp, 2, backend="gloo", timeout=300,
                     args=((2, 1), CASES, True))


@pytest.fixture(scope="module")
def tp22():
    return run_world(W.world_tp, 4, backend="gloo", timeout=300,
                     args=((2, 2), CASES))


CASES_POD = {a: (a, {}) for a in ("qwen3_0_6b", "hymba_1_5b", "grok_1_314b")}


@pytest.fixture(scope="module")
def pod212():
    return run_world(W.world_tp, 4, backend="gloo", timeout=300,
                     args=((2, 1, 2), CASES_POD, True))


def _check_vs_one(ranks, name):
    one = ranks[0][name]["one"]
    for r, rr in enumerate(ranks):
        res = rr[name]
        assert abs(res["loss"] - one["loss"]) <= TOL * abs(one["loss"]), (r, name)
        assert set(res["grads"]) == set(one["grads"])
        for k, want in one["grads"].items():
            scale = float(np.abs(want).max()) or 1.0
            err = float(np.abs(res["grads"][k] - want).max()) / scale
            assert err <= TOL, (r, name, k, err)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_matches_one_device(tp12, name):
    _check_vs_one(tp12, name)


@pytest.mark.parametrize("name", list(CASES_TP4))
def test_tp4_head_guards_match_one_device(tp14, name):
    _check_vs_one(tp14, name)
    split = tp14[0][name]["split"]
    if name not in ("olmoe_1b_7b", "musicgen_large"):
        assert split["heads"] and not split["kv"]
    else:
        assert not split["heads"] and not split["kv"]


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_matches_one_device(fsdp21, name):
    _check_vs_one(fsdp21, name)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_dp_matches_one_device(tp22, name):
    _check_vs_one(tp22, name)


def test_sequence_parallel_collectives():
    """Nemotron's smoke config on a (1, 2) MeshShape in record mode: each
    region gathers the sequence on entry and reduce-scatters it on exit
    (forward; the transposes in the backward), and each norm's scale is
    all-reduced in the backward."""
    import collections
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import value_and_grad
    cfg = W.tp_cfg("nemotron_4_340b")
    mesh = MeshShape((1, 2))
    ac = SH.make_ac(mesh, cfg, mode="record")
    full = TMD.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.from_numpy(W.tp_batch(cfg, **W.TP_BATCH)["tokens"])}
    value_and_grad(cfg, SH.shard_params(cfg, full, mesh, specs=ac.specs), batch, ac=ac)
    seen = collections.Counter((r["op"], r["phase"]) for r in ac.records)
    regions = 2 * cfg.n_layers
    B, S, d = W.TP_BATCH["B"], W.TP_BATCH["S"], cfg.d_model
    assert seen[("reduce-scatter", "fwd")] == regions
    assert seen[("all-gather", "fwd")] == regions + 1          # + the final states
    assert seen[("reduce-scatter", "bwd")] == regions
    assert seen[("all-gather", "bwd")] == regions + 1          # + the embedding's
    assert seen[("all-reduce", "bwd")] == 2 * cfg.n_layers + 1 + 1   # norms, head input
    assert all(r["bytes"] == B * S * d * 4 for r in ac.records
               if r["op"] in ("all-gather", "reduce-scatter"))


SEQ_SHARD = ["nemotron_4_340b", "grok_1_314b", "qwen2_vl_72b"]


@pytest.fixture(scope="module")
def tp12_bf16():
    return run_world(W.world_tp_bf16, 2, backend="gloo", timeout=300,
                     args=(SEQ_SHARD,))


@pytest.mark.parametrize("arch", SEQ_SHARD)
def test_seq_shard_bf16_collectives_match_one_device(tp12_bf16, arch):
    """Sequence parallelism in bf16 on gloo: the backend's own bf16
    all-reduce, all-gather and reduce-scatter, held to one device at the
    bf16 bounds of ``test_torch_models``."""
    assert tconfigs.get_smoke(arch).compute_dtype == "bfloat16"
    one = tp12_bf16[0][arch]["one"]
    for rr in tp12_bf16:
        res = rr[arch]
        assert abs(res["loss"] - one["loss"]) <= BF16["rtol"] * abs(one["loss"])
        for k, want in one["grads"].items():
            scale = float(np.abs(want).max()) or 1.0
            err = float(np.abs(res["grads"][k] - want).max()) / scale
            assert err <= BF16_REL_TO_MAX, (arch, k, err)


@pytest.mark.parametrize("name", list(CASES_POD))
def test_pod_data_model_mesh_matches_one_device(pod212, name):
    """A (pod, data, model) mesh from make_production_mesh: the data axes
    (pod and data) averaged and FSDP-split together."""
    _check_vs_one(pod212, name)


def test_degrade_keeps_attention_and_vocab_replicated(tp12):
    assert tp12[0]["hymba_degrade"]["split"] == {
        "heads": False, "kv": False, "mlp": True, "moe": False, "ssm": True,
        "vocab": False}
    assert tp12[0]["hymba_1_5b"]["split"] == {
        "heads": True, "kv": True, "mlp": True, "moe": False, "ssm": True,
        "vocab": True}


@functools.lru_cache(maxsize=None)
def _ref_loss_fn(jcfg):
    return jax.jit(lambda p, b: JMD.loss_fn(jcfg, p, b))


@pytest.mark.parametrize("name", list(CASES))
def test_tp_loss_matches_reference(tp12, name):
    arch, change = CASES[name]
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), compute_dtype="float32",
                               **change)
    params = TMD.unflatten({k: jnp.asarray(v) for k, v in
                            tp12[0][name]["params"].items()})
    b = {k: jnp.asarray(v) for k, v in W.tp_batch(W.tp_cfg(arch, **change),
                                                  **W.TP_BATCH).items()}
    want = float(_ref_loss_fn(jcfg)(params, b))
    for rr in tp12:
        assert abs(rr[name]["loss"] - want) <= F32["rtol"] * abs(want)


# ----------------------------- training and serving ----------------------- #
TRAIN_ARCH = "qwen3_0_6b"


@pytest.fixture(scope="module")
def tp_train(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    ranks = run_world(W.world_tp_train, 4, backend="gloo", timeout=300,
                      args=(TRAIN_ARCH, ckpt, SERVE_ARCHS))
    resumed = run_world(W.world_tp_resume, 1, backend="gloo", timeout=300,
                        args=(TRAIN_ARCH, ckpt))[0]
    cfg = W.tp_cfg(TRAIN_ARCH)
    one = {"compressed": W.tp_train_run(cfg, None, W.GlobalPipeline(cfg, 2),
                                        W.TP_TRAIN["steps"], compress=True),
           "whole": W.tp_train_run(cfg, None, W.GlobalPipeline(cfg, 2),
                                   W.TP_TRAIN["resumed"]),
           "start": {k: v.numpy() for k, v in TMD.flatten(TMD.init_params(
               cfg, torch.Generator().manual_seed(0))).items()}}
    return ranks, resumed, one


# f32 on the CPU: the (2, 2) and resumed runs' changes agree with one
# device's to 1e-6 over all and 4e-5 on a leaf; one step more or less, or
# a halved last step, is off by 0.1 or more
UPDATE_TOL, UPDATE_LEAF_TOL = 1e-4, 3e-4


def _params_close(got, want, start):
    """The parameter change ``got - start`` against one device's ``want -
    start``: ``||d - d_one|| / ||d_one||`` within ``UPDATE_TOL`` over all
    leaves and ``UPDATE_LEAF_TOL`` on each leaf that moved."""
    err = want_sq = 0.0
    for k, w in want.items():
        e = float(np.sum(np.square(got[k] - w)))
        n = float(np.sum(np.square(w - start[k])))
        assert e <= UPDATE_LEAF_TOL ** 2 * n, k
        err, want_sq = err + e, want_sq + n
    assert want_sq > 0 and err <= UPDATE_TOL ** 2 * want_sq


def test_train_loop_tp_dp_with_compression_matches_one_device(tp_train):
    ranks, _, one = tp_train
    for rr in ranks:
        got = rr["compressed"]
        np.testing.assert_allclose(got["losses"], one["compressed"]["losses"],
                                   rtol=TOL)
        _params_close(got["params"], one["compressed"]["params"], one["start"])
    a, b = (ranks[0]["compressed"]["params"], ranks[3]["compressed"]["params"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_resume_onto_another_mesh_continues_the_run(tp_train):
    ranks, resumed, one = tp_train
    n = W.TP_TRAIN["steps"]
    whole = one["whole"]
    for rr in ranks:
        assert rr["failed"][0] == "RuntimeError" and "injected" in rr["failed"][1]
    assert len(resumed["losses"]) == W.TP_TRAIN["resumed"] - n
    np.testing.assert_allclose(resumed["losses"], whole["losses"][n:], rtol=TOL)
    _params_close(resumed["params"], whole["params"], one["start"])


@pytest.fixture(scope="module")
def tp_serve():
    return run_world(W.world_tp_serve, 2, backend="gloo", timeout=300,
                     args=(SERVE_ARCHS,))


@pytest.fixture(scope="module")
def tp4_serve():
    return run_world(W.world_tp_serve, 4, backend="gloo", timeout=300,
                     args=(SERVE_TP4,))


# at tp = 4 each rank caches only the KV heads its query heads read
SERVE_TP4 = ["qwen3_0_6b", "hymba_1_5b", "olmoe_1b_7b"]


@pytest.mark.parametrize("arch", SERVE_TP4)
def test_tp4_server_matches_one_device(tp4_serve, arch):
    one = tp4_serve[0][arch]["one"]
    for rr in tp4_serve:
        assert rr[arch]["tp"] == one


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_tp_server_matches_one_device(tp_serve, tp_train, arch):
    one = tp_serve[0][arch]["one"]
    assert len(one) == 5 and all(len(t) == 8 for t in one.values())
    for rr in tp_serve:
        assert rr[arch]["tp"] == one
    for rr in tp_train[0]:                     # (2, 2): slots over data
        assert rr["serve"][arch] == one
