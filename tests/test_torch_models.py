"""The port's dense decoder LM against the reference package's model: the
same parameters (carried across by ``params_from_jax``) and the same tokens
through ``forward``/``logits_fn``, ``loss_fn`` and its gradient, and
``decode_step``, on the smoke configs of Qwen3-0.6B and TinyLlama-1.1B, in
f32 and in the models' bf16, and through the long-sequence (flash) branch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.launch.steps import make_prefill_step as j_prefill
from repro.models import layers as JL
from repro.models import model as JMD

from repro_torch import configs as tconfigs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import flash
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import layers as TL
from repro_torch.models import model as TMD

ARCHS = ["qwen3_0_6b", "tinyllama_1_1b"]
# f32: the two frameworks' f32 matmuls, softmax and RoPE tables differ in
# the last bits (RoPE's theta ** x alone is ~1 ulp apart); logits and
# gradients agree far inside these bounds.
F32 = dict(rtol=1e-4, atol=1e-5)
# bf16: the reference's decode-vs-forward bound (tests/test_archs.py:80).
# Within one package it holds element by element (test_decode_matches_
# forward).  Across the two it is taken relative to the largest entry: they
# round bf16 intermediates at different places (XLA on the CPU keeps excess
# f32 precision in fused elementwise chains, and a sum accumulated in
# another order can round to the neighbouring bf16 value), so a few logits
# in a thousand differ by up to ~1.4e-2 of the largest.
BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_REL_TO_MAX = 3e-2


def _close(got, want, dtype, what=""):
    """f32: element by element; bf16: max |got - want| / max |want|."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32, err_msg=what)
    else:
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        assert rel <= BF16_REL_TO_MAX, (what, rel)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="bfloat16"):
    return (dataclasses.replace(jconfigs.get_smoke(arch), compute_dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke(arch), compute_dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, TMD.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _np(t):
    return t.detach().float().numpy()


def test_configs_are_copies_of_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for arch in jconfigs.ARCHS:
        for get in ("get", "get_smoke"):
            assert dataclasses.asdict(getattr(tconfigs, get)(arch)) == \
                dataclasses.asdict(getattr(jconfigs, get)(arch)), (arch, get)
    assert tconfigs.canonical("qwen3-0.6b") == "qwen3_0_6b"


def test_token_pipeline_matches_reference():
    for step in (0, 3):
        np.testing.assert_array_equal(
            TokenPipeline(151936, 64, 2, seed=0).batch(step),
            JTokenPipeline(151936, 64, 2, seed=0).batch(step))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_prefill_match_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(tcfg, 2, 64)
    x, _ = JMD.forward(jcfg, jp, jnp.asarray(toks))
    want = JMD.logits_fn(jcfg, jp, x)
    got = TMD.logits_fn(tcfg, tp, TMD.forward(tcfg, tp, torch.from_numpy(toks)))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    _close(_np(got), _f32(want), dtype)
    lg = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    _close(_np(lg), _f32(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})),
           dtype)


def _loss_and_grads(jcfg, tcfg, jp, tp, toks):
    jl, jg = jax.value_and_grad(
        lambda p: JMD.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)}))(jp)
    leaves = dict(TMD._leaves(tp))
    for t in leaves.values():
        t.requires_grad_()
    tl = TMD.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    return float(jl), dict(TMD._leaves(jax.tree.map(np.asarray, jg))), \
        float(tl.detach()), tg


def _assert_grads(jg, tg, dtype):
    """Each leaf relative to its largest entry."""
    for path, g in tg.items():
        want = _f32(jg[path])
        scale = float(np.abs(want).max()) or 1.0
        _close(_np(g) / scale, want / scale, dtype, "/".join(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, dtype):
    """Gradients are compared relative to each leaf's largest entry."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    jl, jg, tl, tg = _loss_and_grads(jcfg, tcfg, jp, tp, _tokens(tcfg, 2, 64))
    assert abs(tl - jl) <= (F32["rtol"] if dtype == "float32"
                            else BF16_REL_TO_MAX) * abs(jl)
    _assert_grads(jg, tg, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_cache_match_reference(arch, dtype):
    """Two sequences at staggered depths (positions t and t + 3)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(tcfg, 2, 10)
    jc = JMD.init_cache(jcfg, 2, 16)
    tc = TMD.init_cache(tcfg, 2, 16, device="cpu")
    for t in range(8):
        pos = np.array([t, t + 3], np.int32)
        cur = np.array([toks[0, t], toks[1, t + 2]], np.int32)
        jl, jc = JMD.decode_step(jcfg, jp, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc = TMD.decode_step(tcfg, tp, tc, torch.from_numpy(cur),
                                 torch.from_numpy(pos))
        _close(_np(tl), _f32(jl), dtype, f"step {t}")
    for name in ("k", "v"):
        _close(_np(tc[name]), _f32(jc[name]), dtype, name)


def test_long_branch_forward_and_gradient_match_reference():
    """S = 3072 (> 2048, a multiple of 1024): the reference's chunked jnp
    attention against the port's flash path (its plain version here)."""
    jcfg, tcfg = _cfgs("qwen3_0_6b", "float32")
    jcfg = dataclasses.replace(jcfg, n_layers=1)
    tcfg = dataclasses.replace(tcfg, n_layers=1)
    jp, tp = _params(jcfg, tcfg, seed=2)
    toks = _tokens(tcfg, 1, 3072, seed=3)
    x, _ = JMD.forward(jcfg, jp, jnp.asarray(toks))
    got = TMD.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _f32(x), **F32)
    jl, jg, tl, tg = _loss_and_grads(jcfg, tcfg, jp, tp, toks)
    assert abs(tl - jl) <= F32["rtol"] * abs(jl)
    _assert_grads(jg, tg, "float32")


def test_long_branch_at_a_head_dim_without_kernels_matches_reference():
    """Head dim 192 (Nemotron-4 340B's 18432 / 96): on CPU tensors the
    port's long branch (S = 3072, 4 query heads over 2 kv heads) takes the
    plain version, forward and gradient (on the card it launches the
    kernels' hd-192 instances, tests/test_torch_cuda.py), and matches the
    reference's chunked jnp attention (``layers._flash_attention``), which
    takes any head dim.  The gradients are compared relative to each one's
    largest entry."""
    B, S, H, KV, hd = 1, 3072, 4, 2, 192
    assert flash.has_kernel(hd)
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
                   for n in (H, KV, KV, H))
    want, vjp = jax.vjp(
        lambda *a: JL._flash_attention(*a, None, None, 1024, 1024), q, k, v)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = TL._flash(*args, None, "auto")
    np.testing.assert_allclose(_np(got), _f32(want), **F32)
    grads = torch.autograd.grad((got * torch.from_numpy(do)).sum(), args)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        scale = float(np.abs(_f32(w)).max())
        np.testing.assert_allclose(_np(g) / scale, _f32(w) / scale, **F32)


@pytest.mark.parametrize("S", [256, 3072])
def test_windowed_attention_train_matches_reference(S):
    """attention_train with a sliding window, on the dense branch (S <=
    2048) and the flash branch (its plain version here), against the
    reference's, as a windowed layer calls it (is_global=None)."""
    jcfg, tcfg = _cfgs("qwen3_0_6b", "float32")
    jp, tp = _params(jcfg, tcfg)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {n: t[0] for n, t in tp["layers"]["attn"].items()}
    x = np.random.default_rng(4).normal(
        size=(1, S, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None]
    want = JL.attention_train(jl, jnp.asarray(x), jcfg, jnp.asarray(pos),
                              window=200)
    got = TL.attention_train(tl, torch.from_numpy(x), tcfg,
                             torch.from_numpy(pos), window=200)
    np.testing.assert_allclose(_np(got), _f32(want), **F32)


def test_attention_backend_routes():
    """backend="ref" is the plain version on any device (on the CPU the
    same as "auto"); anything else is refused."""
    _, tcfg = _cfgs("qwen3_0_6b", "float32")
    tcfg = dataclasses.replace(tcfg, n_layers=1)
    tp = TMD.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(tcfg, 1, 3072))
    assert torch.equal(TMD.forward(tcfg, tp, toks),
                       TMD.forward(tcfg, tp, toks, backend="ref"))
    with pytest.raises(ValueError, match="backend"):
        TMD.forward(tcfg, tp, toks[:, :16], backend="cuda")


def test_long_branch_needs_whole_chunks():
    _, tcfg = _cfgs("qwen3_0_6b", "float32")
    tcfg = dataclasses.replace(tcfg, n_layers=1)
    tp = TMD.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of 1024"):
        TMD.forward(tcfg, tp, torch.zeros((1, 2560), dtype=torch.int64))


def test_decode_matches_forward():
    """Greedy decode logits at position t == forward logits at t (the port's
    two attention paths; tests/test_archs.py:68 for the reference).  The
    weights cast once (compute_params) give the same values, bit for bit."""
    _, tcfg = _cfgs("tinyllama_1_1b")
    tp = TMD.init_params(tcfg, torch.Generator().manual_seed(0))
    tc = TMD.compute_params(tcfg, tp)
    assert tc["final_norm"].dtype == torch.float32
    assert tc["layers"]["attn"]["wq"].dtype == torch.bfloat16
    toks = torch.from_numpy(_tokens(tcfg, 1, 8))
    full = TMD.logits_fn(tcfg, tp, TMD.forward(tcfg, tp, toks))
    assert torch.equal(full, TMD.logits_fn(tcfg, tc, TMD.forward(tcfg, tc, toks)))
    cache = TMD.init_cache(tcfg, 1, 8, device="cpu")
    cache_c = TMD.init_cache(tcfg, 1, 8, device="cpu")
    for t in range(8):
        lg, cache = TMD.decode_step(tcfg, tp, cache, toks[:, t], t)
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), **BF16)
        lg_c, cache_c = TMD.decode_step(tcfg, tc, cache_c, toks[:, t], t)
        assert torch.equal(lg, lg_c)


def test_module_form_and_parameter_tree(monkeypatch):
    jcfg, tcfg = _cfgs("qwen3_0_6b", "float32")
    jp, tp = _params(jcfg, tcfg)
    lm = TMD.DecoderLM(tcfg, params=tp, device="cpu")
    n = sum(int(np.prod(s)) for _, s in TMD._leaves(TMD.param_shapes(tcfg)))
    assert sum(p.numel() for p in lm.parameters()) == n == sum(
        int(np.size(a)) for a in jax.tree.leaves(jp))
    toks = torch.from_numpy(_tokens(tcfg, 1, 16))
    np.testing.assert_array_equal(
        _np(lm(toks)), _np(TMD.logits_fn(tcfg, tp, TMD.forward(tcfg, tp, toks))))
    own = TMD.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = dict(TMD._leaves(TMD.param_shapes(tcfg)))
    for path, t in TMD._leaves(own):
        assert tuple(t.shape) == shapes[path] and t.dtype == torch.float32
    bad = jax.tree.map(np.asarray, jp)
    bad["final_norm"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        TMD.params_from_jax(bad, tcfg, device="cpu")
    del bad["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        TMD.params_from_jax(bad, tcfg, device="cpu")
    # entry points default to the card, and say how to ask for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TMD.DecoderLM(tcfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TMD.init_cache(tcfg, 1, 8)
