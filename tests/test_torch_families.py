"""The port's other LM families against the reference package: the MoE
layer (``models/moe.py``: dense, ragged and capacity-gather dispatch, with
a router that overflows one expert's capacity), the Mamba block
(``models/mamba.py``: the chunked scan and one-token decode), M-RoPE and
windowed/global attention (``models/layers.py``), and for each of the six
non-dense configs (Falcon-Mamba, Grok-1, OLMoE, Hymba, Qwen2-VL, MusicGen)
at ``get_smoke`` sizes: forward logits, loss and every gradient, decode
steps and caches, in f32 and in the models' bf16 (the tolerances of
``tests/test_torch_models.py``); a 3-layer Hymba through the long
(flash) branch; ``make_train_step`` against the reference's; the ``Server``
against offline greedy decoding and the reference's ``decode_step``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as JS
from repro.launch.steps import make_prefill_step as j_prefill
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import model as JMD
from repro.models import moe as JMOE
from repro.optim import adamw as jadamw
from repro.optim import warmup_cosine as jwarmup_cosine

from repro_torch import configs as tconfigs
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.launch.serve import Request, Server
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import model as TMD
from repro_torch.models import moe as TMOE

from test_torch_lm_train import _assert_updates
from test_torch_models import BF16_REL_TO_MAX, F32, _close, _f32, _np

FAMILY_ARCHS = [a for a in jconfigs.ARCHS if jconfigs.get(a).family != "dense"]
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="bfloat16", **change):
    return (dataclasses.replace(jconfigs.get_smoke(arch), compute_dtype=dtype, **change),
            dataclasses.replace(tconfigs.get_smoke(arch), compute_dtype=dtype, **change))


@functools.lru_cache(maxsize=None)
def _ref_params(jcfg, seed):
    init = jax.jit(JMD.init_params, static_argnums=0)
    return jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(seed)))


def _params(jcfg, tcfg, seed=0):
    """The reference's initial parameters (the same for both compute
    dtypes, f32 masters) as its tree and as the port's."""
    jp = _ref_params(dataclasses.replace(jcfg, compute_dtype="float32"), seed)
    return (jax.tree.map(jnp.asarray, jp),
            TMD.params_from_jax(jp, tcfg, device="cpu"))


_jdecode = jax.jit(JMD.decode_step, static_argnums=0)


def _batch(cfg, B, S, seed=1):
    """numpy: tokens (B, S) or (B, nq, S); a VLM's vision embeddings and
    M-RoPE positions whose three sections differ (a 2 x 4 patch grid at
    temporal index 0, then the text at one index past the grid's largest)."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks > 1 else (B, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)}
    if cfg.vision_tokens:
        nv = cfg.vision_tokens
        out["vision_embeds"] = (0.01 * rng.normal(size=(B, nv, cfg.d_model))).astype(np.float32)
        i = np.arange(nv)
        grid = np.stack([np.zeros(nv), i // 4, i % 4]).astype(np.int64)
        text = np.broadcast_to(np.arange(S) + grid.max() + 1, (3, S))
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.concatenate([grid, text], 1)[:, None], (3, B, nv + S)))
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
def _moe_inputs(arch, dtype, seed=0, skew=False):
    jcfg, tcfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(seed)
    shapes = TMOE.moe_param_shapes(tcfg)
    p = {n: (rng.normal(size=s) / np.sqrt(s[-2])).astype(np.float32)
         for n, s in shapes.items()}
    if skew:
        # most tokens' largest logit on expert 0: it overflows its capacity
        p["router"][:, 0] += 0.5
    x = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    if skew:
        x[..., :] += np.sign(p["router"][:, 0])
    cdt = getattr(jnp, dtype)
    jp = {n: jnp.asarray(a).astype(cdt) for n, a in p.items()}
    tp = {n: torch.from_numpy(a).to(getattr(torch, dtype)) for n, a in p.items()}
    return jcfg, tcfg, jp, tp, jnp.asarray(x).astype(cdt), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["dense", "ragged", "gather"])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "grok_1_314b"])
def test_moe_matches_reference(arch, impl, dtype):
    """OLMoE (swiglu, 4 experts top-2 at smoke size) and Grok-1 (gelu):
    the layer's output and its aux loss, each path against the
    reference's on the same inputs; f32 element by element, bf16 relative
    to the largest entry."""
    jcfg, tcfg, jp, tp, jx, tx = _moe_inputs(arch, dtype)
    want, jaux = {"dense": JMOE.moe_dense, "ragged": JMOE.moe_ragged,
                  "gather": JMOE.moe_gather}[impl](jp, jx, jcfg)
    got, taux = {"dense": TMOE.moe_dense, "ragged": TMOE.moe_ragged,
                 "gather": TMOE.moe_gather}[impl](tp, tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(_np(got), _f32(want), dtype, impl)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "grok_1_314b"])
def test_moe_gather_drops_the_reference_slots(arch):
    """A router that sends most tokens to expert 0: ``moe_gather`` drops the
    slots past its capacity, the same ones as the reference (its stable
    sort keeps the earliest tokens), and the drop count is reported."""
    jcfg, tcfg, jp, tp, jx, tx = _moe_inputs(arch, "float32", seed=3, skew=True)
    stats = {}
    got, _ = TMOE.moe_gather(tp, tx, tcfg, stats)
    want, _ = JMOE.moe_gather(jp, jx, jcfg)
    # with capacity 20 a group of 32 tokens must drop
    C = TMOE.capacity(tcfg, 32)
    assert C == max(4, int(round(tcfg.moe.top_k * 32 / tcfg.moe.n_experts * 1.25)))
    assert int(stats["dropped"]) > 0
    np.testing.assert_allclose(_np(got), _f32(want), **F32)
    # a dropped slot changes its token's output: the ragged path drops none
    full, _ = TMOE.moe_ragged(tp, tx, tcfg)
    assert not torch.allclose(got, full, **F32)


def test_moe_apply_routes_by_impl():
    jcfg, tcfg, jp, tp, jx, tx = _moe_inputs("olmoe_1b_7b", "float32")
    for impl in TMOE.IMPLS:
        cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, impl=impl))
        want, _ = getattr(TMOE, f"moe_{impl}")(tp, tx, cfg)
        assert torch.equal(TMOE.moe_apply(tp, tx, cfg)[0], want), impl
    with pytest.raises(ValueError, match="moe impl"):
        TMOE.moe_apply(tp, tx, dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, impl="sparse")))


# --------------------------------------------------------------------------- #
# Mamba
# --------------------------------------------------------------------------- #
def _ssm_params(cfg, seed=0):
    jp = jax.tree.map(np.asarray, JM.init_ssm_params(jax.random.PRNGKey(seed), cfg,
                                                    jnp.float32))
    return jp, {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}


@pytest.mark.parametrize("chunk", [16, 64])
def test_mamba_train_matches_reference(chunk):
    """Falcon-Mamba's smoke block at S = 64: one chunk of 64, or four of 16
    threaded in order, against the reference's associative scan (f32)."""
    jcfg, tcfg = _cfgs("falcon_mamba_7b", "float32")
    jp, tp = _ssm_params(tcfg)
    x = np.random.default_rng(2).normal(size=(2, 64, tcfg.d_model)).astype(np.float32)
    want = JM.mamba_train(jp, jnp.asarray(x), jcfg, chunk=chunk)
    got = TM.mamba_train(tp, torch.from_numpy(x), tcfg, chunk=chunk)
    np.testing.assert_allclose(_np(got), _f32(want), **F32)
    with pytest.raises(ValueError, match="chunk"):
        TM.mamba_train(tp, torch.from_numpy(x[:, :40]), tcfg, chunk=16)


def test_scan_is_the_sequential_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t step by step."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand((2, 37, 3), generator=g), torch.randn((2, 37, 3), generator=g)
    acum, hcum = TM._scan(a, b)
    h, p = torch.zeros(2, 3), torch.ones(2, 3)
    for t in range(37):
        h, p = a[:, t] * h + b[:, t], a[:, t] * p
        torch.testing.assert_close(hcum[:, t], h)
        torch.testing.assert_close(acum[:, t], p)


def test_mamba_decode_and_states_match_reference():
    """Eight one-token steps from zero states: the outputs, the conv
    history and the f32 ssm state against the reference's (f32)."""
    jcfg, tcfg = _cfgs("falcon_mamba_7b", "float32")
    jp, tp = _ssm_params(tcfg, seed=1)
    xs = np.random.default_rng(3).normal(size=(2, 8, tcfg.d_model)).astype(np.float32)
    K, di, N = tcfg.ssm.d_conv, tcfg.d_inner, tcfg.ssm.d_state
    jc, js = jnp.zeros((2, K - 1, di)), jnp.zeros((2, di, N))
    tc, ts = torch.zeros((2, K - 1, di)), torch.zeros((2, di, N))
    for t in range(8):
        jy, jc, js = JM.mamba_decode(jp, jnp.asarray(xs[:, t:t + 1]), jcfg, jc, js)
        ty, tc, ts = TM.mamba_decode(tp, torch.from_numpy(xs[:, t:t + 1]), tcfg, tc, ts)
        np.testing.assert_allclose(_np(ty), _f32(jy), **F32)
    np.testing.assert_allclose(_np(tc), _f32(jc), **F32)
    np.testing.assert_allclose(_np(ts), _f32(js), **F32)
    assert ts.dtype == torch.float32


# --------------------------------------------------------------------------- #
# Attention: M-RoPE, windowed and global layers
# --------------------------------------------------------------------------- #
def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, 2, 12))
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (2, 3, 3), 1e6)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (2, 3, 3), 1e6)
    np.testing.assert_allclose(_np(got), _f32(want), **F32)
    # one section's ids move only its own frequencies
    pos2 = pos.copy()
    pos2[1] += 7
    moved = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos2), (2, 3, 3), 1e6)
    diff = (moved - got).abs().amax(dim=(0, 1, 2))
    assert bool((diff[[0, 1, 8, 9]] == 0).all()) and bool((diff[2:5] > 0).all())


def _hymba_attn(seed=0):
    jcfg, tcfg = _cfgs("hymba_1_5b", "float32")
    jp, tp = _params(jcfg, tcfg, seed)
    return (jcfg, tcfg, jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
            {n: t[0] for n, t in tp["layers"]["attn"].items()})


@pytest.mark.parametrize("is_global", [False, True])
def test_windowed_and_global_attention_train_match_reference(is_global):
    """Hymba's smoke attention (window 32) at S = 128: a windowed layer, and
    a global one (the port passes window=None, the reference the traced
    flag)."""
    jcfg, tcfg, jl, tl = _hymba_attn()
    x = np.random.default_rng(4).normal(size=(1, 128, tcfg.d_model)).astype(np.float32)
    pos = np.arange(128)[None]
    want = JL.attention_train(jl, jnp.asarray(x), jcfg, jnp.asarray(pos),
                              window=32, is_global=jnp.asarray(is_global))
    got = TL.attention_train(tl, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                             window=None if is_global else 32)
    np.testing.assert_allclose(_np(got), _f32(want), **F32)


@pytest.mark.parametrize("is_global", [None, False, True])
def test_attention_decode_window_matches_reference(is_global):
    """Window 4, two sequences at staggered depths up to 11: the cache (16
    long, no ring) with is_global None, False and True."""
    jcfg, tcfg, jl, tl = _hymba_attn(seed=1)
    rng = np.random.default_rng(5)
    jk = jv = jnp.zeros((2, 16, tcfg.n_kv_heads, tcfg.resolved_head_dim))
    tk = torch.zeros((2, 16, tcfg.n_kv_heads, tcfg.resolved_head_dim))
    tv = tk.clone()
    for t in range(9):
        x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        pos = np.array([t, t + 3])
        want, jk, jv = JL.attention_decode(
            jl, jnp.asarray(x), jcfg, jk, jv, jnp.asarray(pos), window=4,
            is_global=None if is_global is None else jnp.asarray(is_global))
        got, tk, tv = TL.attention_decode(tl, torch.from_numpy(x), tcfg, tk, tv,
                                          torch.from_numpy(pos), window=4,
                                          is_global=is_global)
        np.testing.assert_allclose(_np(got), _f32(want), **F32, err_msg=str(t))


def test_ring_buffer_decode_past_the_window_matches_reference():
    """Hymba's smoke config with every layer windowed (global_attn_every=0):
    the cache is the window long (32) and written as a ring; 48 decode
    steps run past it, against the reference's decode_step (f32)."""
    jcfg, tcfg = _cfgs("hymba_1_5b", "float32", global_attn_every=0)
    jp, tp = _params(jcfg, tcfg, seed=2)
    assert TMD.cache_shapes(tcfg, 1, 64)["k"][0][2] == 32
    assert not TMD._layer_windows(tcfg).any()
    toks = _batch(tcfg, 1, 48, seed=6)["tokens"]
    jc, tc = JMD.init_cache(jcfg, 1, 64), TMD.init_cache(tcfg, 1, 64, device="cpu")
    for t in range(48):
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(toks[:, t]), t)
        tl, tc = TMD.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]), t)
        if t % 8 == 7:
            np.testing.assert_allclose(_np(tl), _f32(jl), **F32, err_msg=str(t))
    for name in jc:
        np.testing.assert_allclose(_np(tc[name]), _f32(jc[name]), **F32, err_msg=name)


# --------------------------------------------------------------------------- #
# The six non-dense configs, end to end
# --------------------------------------------------------------------------- #
def _logits_all(cfg, params, x, fn):
    return [fn(cfg, params, x, q) for q in range(cfg.n_codebooks)]


# A token whose router puts less than this between its k-th and (k+1)-th
# expert probability, in some layer, may be routed otherwise by the other
# package in bf16 (its hidden state differs there in the last bits): the
# two tokens so routed in the smoke batches had gaps of 1.8e-3 and 2.0e-3,
# and final hidden states up to 0.34 and 0.57 apart (every other token's up
# to 0.05).  The bound is twice the larger of those two gaps.
ROUTER_TIE = 4e-3


def _router_gaps(monkeypatch):
    """Record each MoE layer's per-token gap between the k-th and (k+1)-th
    router probability while the port runs."""
    gaps, router = [], TMOE._router

    def recording(params, x, cfg):
        out = router(params, x, cfg)
        top = out[2].topk(cfg.moe.top_k + 1, dim=-1).values
        gaps.append((top[:, -2] - top[:, -1]).detach())
        return out

    monkeypatch.setattr(TMOE, "_router", recording)
    return gaps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_logits_and_prefill_match_reference(arch, dtype, monkeypatch):
    """For the MoE configs in bf16, the tokens of a near-tie in the router
    (ROUTER_TIE) are left out of the logits' comparison, and must be few."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    b = _batch(tcfg, 2, 32)
    jx, _ = JMD.forward(jcfg, jp, jnp.asarray(b["tokens"]),
                        b.get("vision_embeds"), b.get("positions"))
    tb = _t(b)
    gaps = _router_gaps(monkeypatch)
    tx = TMD.forward(tcfg, tp, tb["tokens"], tb.get("positions"),
                     vision_embeds=tb.get("vision_embeds"))
    assert tx.dtype == getattr(torch, dtype) and tuple(tx.shape) == jx.shape
    keep = np.ones(tx.shape[:2], bool)
    if gaps and dtype == "bfloat16":
        keep = (torch.stack(gaps).amin(0) >= ROUTER_TIE).reshape(keep.shape).numpy()
        assert keep.mean() >= 0.9, keep.mean()
    for q, (got, want) in enumerate(zip(_logits_all(tcfg, tp, tx, TMD.logits_fn),
                                        _logits_all(jcfg, jp, jx, JMD.logits_fn))):
        _close(_np(got)[keep], _f32(want)[keep], dtype, f"codebook {q}")
    if keep.all():
        got = TS.make_prefill_step(tcfg)(tp, tb)
        _close(_np(got), _f32(j_prefill(jcfg)(jp, _j(b))), dtype, "prefill")


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(jcfg, seed, B, S, batch_seed):
    """The reference's loss and gradients (jitted), as numpy."""
    b = _j(_batch(jcfg, B, S, batch_seed))
    jp = jax.tree.map(jnp.asarray, _ref_params(
        dataclasses.replace(jcfg, compute_dtype="float32"), seed))
    loss, g = jax.jit(jax.value_and_grad(lambda p: JMD.loss_fn(jcfg, p, b)))(jp)
    return float(loss), dict(TMD._leaves(jax.tree.map(np.asarray, g)))


def _port_loss_and_grads(tcfg, tp, b):
    leaves = dict(TMD._leaves(tp))
    for t in leaves.values():
        t.requires_grad_()
    tl = TMD.loss_fn(tcfg, tp, _t(b))
    return float(tl.detach()), dict(zip(leaves, torch.autograd.grad(
        tl, list(leaves.values()))))


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _check_loss_and_grads(arch, dtype, seed=0, B=2, S=32, batch_seed=1, **change):
    """f32: the loss within F32's rtol and each gradient leaf element by
    element relative to its largest entry.  bf16: the loss within the bf16
    bound; each leaf no further from the reference's f32 gradient than the
    reference's own bf16 gradient is, plus the bf16 bound (in bf16 both
    packages' gradients are ~0.16 of the largest entry away from f32 for
    the MoE configs, whose routing flips on near-ties, and 0.03 for a bias
    summed over every position; readings in CHANGES.md)."""
    jcfg, tcfg = _cfgs(arch, dtype, **change)
    _, tp = _params(jcfg, tcfg, seed)
    jl, jg = _ref_loss_and_grads(jcfg, seed, B, S, batch_seed)
    tl, tg = _port_loss_and_grads(tcfg, tp, _batch(tcfg, B, S, batch_seed))
    assert abs(tl - jl) <= (F32["rtol"] if dtype == "float32"
                            else BF16_REL_TO_MAX) * abs(jl)
    if dtype == "bfloat16":
        _, j32 = _ref_loss_and_grads(dataclasses.replace(jcfg, compute_dtype="float32"),
                                     seed, B, S, batch_seed)
    for path, g in tg.items():
        want = _f32(jg[path])
        scale = float(np.abs(want).max()) or 1.0
        if dtype == "float32":
            np.testing.assert_allclose(_np(g) / scale, want / scale, **F32,
                                       err_msg="/".join(path))
        else:
            own = _rel(want, j32[path])
            assert _rel(_np(g), j32[path]) <= own + BF16_REL_TO_MAX, (path, own)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match_reference(arch, dtype):
    _check_loss_and_grads(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_steps_and_cache_match_reference(arch, dtype):
    """Two sequences at staggered depths (positions t and t + 3); every
    cache entry (k, v, conv, ssm) at the end."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _batch(tcfg, 2, 12)["tokens"]
    jc = JMD.init_cache(jcfg, 2, 16)
    tc = TMD.init_cache(tcfg, 2, 16, device="cpu")
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype), name
    for t in range(8):
        pos = np.array([t, t + 3], np.int32)
        cur = np.stack([toks[0, ..., t], toks[1, ..., t + 2]])
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(cur), jnp.asarray(pos))
        tl, tc = TMD.decode_step(tcfg, tp, tc, torch.from_numpy(cur),
                                 torch.from_numpy(pos))
        assert tuple(tl.shape) == jl.shape
        _close(_np(tl), _f32(jl), dtype, f"step {t}")
    for name in jc:
        _close(_np(tc[name]), _f32(jc[name]), dtype, name)


@pytest.mark.parametrize("change", [dict(sliding_window=8), dict(n_codebooks=2),
                                    dict(rope="mrope", mrope_sections=(2, 3, 3))])
def test_dense_options_match_reference(change):
    """A dense config with a window (every layer windowed: a ring-buffer
    cache), two codebooks or M-RoPE: the loss, and decode past the
    window, against the reference (f32)."""
    jcfg, tcfg = _cfgs("qwen3_0_6b", "float32", **change)
    jp, tp = _params(jcfg, tcfg)
    b = _batch(tcfg, 2, 24)
    want = float(JMD.loss_fn(jcfg, jp, _j(b)))
    assert abs(float(TMD.loss_fn(tcfg, tp, _t(b))) - want) <= F32["rtol"] * abs(want)
    jc, tc = JMD.init_cache(jcfg, 2, 16), TMD.init_cache(tcfg, 2, 16, device="cpu")
    for t in range(12):
        cur = b["tokens"][..., t]
        jl, jc = _jdecode(jcfg, jp, jc, jnp.asarray(cur), t)
        tl, tc = TMD.decode_step(tcfg, tp, tc, torch.from_numpy(cur), t)
    np.testing.assert_allclose(_np(tl), _f32(jl), **F32)


def test_long_hybrid_branch_matches_reference():
    """Hymba at 3 layers (global, windowed, global) and S = 3072: the flash
    branch (its plain version here) with the window of 32 and without, the
    chunked scan over 6 chunks of 512; the loss and gradients (f32)."""
    jcfg, tcfg = _cfgs("hymba_1_5b", "float32", n_layers=3)
    assert TMD._layer_windows(tcfg).tolist() == [True, False, True]
    _check_loss_and_grads("hymba_1_5b", "float32", seed=4, B=1, S=3072, batch_seed=7,
                          n_layers=3)


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #
def test_init_params_special_leaves():
    """Hymba's smoke tree (all four kinds of layer group but moe) and
    OLMoE's: the shapes of the reference's tree, norms and D one, A_log
    log(1..N) in f32, dt_bias the inverse softplus of [1e-3, 1e-1], conv_b
    zero; the rest normal / sqrt(fan_in)."""
    for arch in ("hymba_1_5b", "olmoe_1b_7b"):
        cfg = tconfigs.get_smoke(arch)
        p = TMD.init_params(cfg, torch.Generator().manual_seed(0))
        want = dict(TMD._leaves(jax.tree.map(lambda s: s.shape,
                                             JMD.abstract_params(jconfigs.get_smoke(arch)))))
        got = dict(TMD._leaves(p))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        for path, t in got.items():
            name = path[-1]
            assert t.dtype == torch.float32, path
            if "ln" in name or "norm" in name or name == "D":
                assert bool((t == 1).all()), path
            elif name == "A_log":
                n = cfg.ssm.d_state
                assert torch.equal(t[0, 0], torch.log(torch.arange(1, n + 1).float()))
            elif name == "dt_bias":
                dt = torch.nn.functional.softplus(t)
                assert bool((dt >= 1e-3 * 0.999).all() and (dt <= 0.1 * 1.001).all())
            elif name == "conv_b":
                assert bool((t == 0).all()), path
            else:
                assert abs(float(t.std()) * np.sqrt(t.shape[-2]) - 1) < 0.2, path
    cfg = tconfigs.get_smoke("hymba_1_5b")
    cp = TMD.compute_params(cfg, TMD.init_params(cfg, torch.Generator().manual_seed(0)))
    for name in ("A_log", "dt_bias", "D"):
        assert cp["layers"]["ssm"][name].dtype == torch.float32
    assert cp["layers"]["ssm"]["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decoder_module_takes_every_family(arch):
    """DecoderLM on the reference's parameters: the logits of forward and
    logits_fn, every codebook's for MusicGen, the VLM's after its vision
    embeddings."""
    jcfg, tcfg = _cfgs(arch, "float32")
    _, tp = _params(jcfg, tcfg)
    lm = TMD.DecoderLM(tcfg, params=tp, device="cpu")
    b = _t(_batch(tcfg, 1, 8))
    got = lm(b["tokens"], b.get("positions"), b.get("vision_embeds"))
    x = TMD.forward(tcfg, tp, b["tokens"], b.get("positions"),
                    vision_embeds=b.get("vision_embeds"))
    want = torch.stack([TMD.logits_fn(tcfg, tp, x, q) for q in range(tcfg.n_codebooks)], 1)
    assert torch.equal(got, want if tcfg.n_codebooks > 1 else want[:, 0])


# --------------------------------------------------------------------------- #
# Training and serving
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["hymba_1_5b", "olmoe_1b_7b"])
def test_train_step_matches_reference(arch):
    """Two steps of build's AdamW from the same parameters on the same
    batches, the configs' own grad_accum (4 and 2): loss and gradient norm
    within the bf16 bound, the update by _assert_updates."""
    tcfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
    lr, total = 3e-4, 10
    opt, _ = TT.build(tcfg, None, lr=lr, total_steps=total)
    jopt = jadamw(jwarmup_cosine(lr, min(100, total // 10 + 1), total), weight_decay=0.1)
    jp0 = jax.tree.map(np.asarray, JMD.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TMD.params_from_jax(jp0, tcfg, device="cpu")
    tp0 = TMD.unflatten({k: v.clone() for k, v in TMD.flatten(tp).items()})
    jp = jax.tree.map(jnp.asarray, jp0)
    tstate, jstate = opt.init(TMD.flatten(tp)), jopt.init(jp)
    tstep = TS.make_train_step(tcfg, opt)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    pipe = TokenPipeline(tcfg.vocab_size, 32, 4)
    for i in range(2):
        toks = pipe.batch(i)
        tp, tstate, tm = tstep(tp, tstate, {"tokens": torch.from_numpy(toks)})
        jp, jstate, jm = jstep(jp, jstate, {"tokens": jnp.asarray(toks)})
        for name in ("loss", "grad_norm"):
            got, want = float(tm[name]), float(jm[name])
            assert abs(got - want) <= BF16_REL_TO_MAX * abs(want), (i, name)
        _assert_updates(tp, tp0, jp, jp0, f"{arch} step {i}")


def test_grad_accum_splits_vlm_positions():
    """grad_accum=2 on a VLM batch: the M-RoPE positions (3, B, S) split on
    their row axis with the tokens and vision embeddings; the gradients are
    the halves' g / 2 summed, the loss the second half's, bit for bit."""
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen2_vl_72b"), grad_accum=2)
    p = TMD.init_params(cfg, torch.Generator().manual_seed(0))
    b = _t(_batch(cfg, 4, 16))
    b["positions"][:, 2:] += 5            # the halves' positions differ
    seen = {}

    def capture(g):
        seen.update(g)
        return g

    opt, _ = TT.build(cfg, None)
    _, _, m = TS.make_train_step(cfg, opt, compress_fn=capture)(
        p, opt.init(TMD.flatten(p)), b)
    half = [{k: (v[:, r] if k == "positions" else v[r]) for k, v in b.items()}
            for r in (slice(0, 2), slice(2, 4))]
    (_, g0), (l1, g1) = (TS.value_and_grad(cfg, p, h) for h in half)
    assert torch.equal(m["loss"], l1)
    for k in g0:
        assert torch.equal(seen[k], g0[k] / 2 + g1[k] / 2), k


def test_train_loop_feeds_vision_and_codebooks(capsys):
    """train_loop adds zero vision embeddings for the VLM; main repeats the
    token pipeline over MusicGen's codebooks; both train on the host (at the
    configs' grad_accum, 8 and 4)."""
    cfg = tconfigs.get_smoke("qwen2_vl_72b")
    _, losses = TT.train_loop(cfg, None, TokenPipeline(cfg.vocab_size, 16, 8), 2,
                              log_every=0, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    TT.main(["--arch", "musicgen-large", "--smoke", "--steps", "2", "--batch", "4",
             "--seq", "16", "--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("done.")


def _greedy(cfg, step, init, params, prompt, max_new):
    """Offline greedy decoding of one request; codebook tokens fed and
    kept as the Server does."""
    cache = init()
    out = []
    for t in range(len(prompt) + max_new - 1):
        cur = np.asarray([prompt[t] if t < len(prompt) else out[-1]], np.int32)
        if cfg.n_codebooks > 1:
            cur = np.repeat(cur[:, None], cfg.n_codebooks, 1)
        lg, cache = step(params, cache, cur, np.asarray([t], np.int32))
        if t >= len(prompt) - 1:
            lg = np.asarray(lg, np.float32)
            out.append(int(np.argmax(lg[0, 0] if cfg.n_codebooks > 1 else lg[0])))
    return out


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "hymba_1_5b", "musicgen_large"])
def test_server_matches_offline_and_reference_decode(arch):
    """3 requests on 2 slots, in f32: the third is admitted to a recycled
    slot, whose conv/ssm lanes the Server zeroes, so it must decode as if
    alone; the tokens equal the port's and the reference's greedy loops."""
    jcfg, cfg = _cfgs(arch, "float32")
    jp, params = _params(jcfg, cfg)
    srv = Server(cfg, slots=2, max_len=32, device="cpu", params=params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=5).tolist() for _ in range(3)]
    for rid, p in enumerate(prompts):
        srv.submit(Request(rid, p, max_new=4))
    done = {r.rid: r for r in srv.run()}
    assert len(done) == 3

    def tstep(p, c, cur, pos):
        lg, c = TMD.decode_step(cfg, p, c, torch.from_numpy(cur), torch.from_numpy(pos))
        return lg.numpy(), c

    for rid, p in enumerate(prompts):
        want = _greedy(cfg, tstep, lambda: TMD.init_cache(cfg, 1, 32, device="cpu"),
                       params, p, 4)
        assert done[rid].out == want, (rid, done[rid].out, want)
        assert want == _greedy(jcfg, lambda p_, c, cur, pos: _jdecode(
            jcfg, p_, c, jnp.asarray(cur), jnp.asarray(pos)),
            lambda: JMD.init_cache(jcfg, 1, 32), jp, p, 4), rid
    if cfg.n_codebooks > 1:
        nxt, lg, _ = TS.make_serve_step(cfg)(
            params, TMD.init_cache(cfg, 2, 8, device="cpu"),
            torch.zeros((2, cfg.n_codebooks), dtype=torch.int64), 0)
        assert tuple(nxt.shape) == (2, cfg.n_codebooks) and nxt.dtype == torch.int32


def test_serve_cli_runs_every_family(capsys):
    for arch in ("falcon-mamba-7b", "hymba-1.5b", "qwen2-vl-72b"):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                    "--batch-slots", "2", "--max-new", "3"])
        assert "2 requests" in capsys.readouterr().out, arch
