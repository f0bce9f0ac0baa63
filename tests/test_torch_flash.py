"""The port's flash attention (the CPU path of its kernel wrappers: the
chunked online softmax, and the dense oracle) against the reference
package's Pallas kernels in interpret mode, its oracle and its model's
chunked attention."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash as jflash
from repro.models.layers import _flash_attention as jnp_chunked

from repro_torch import configs, kernels
from repro_torch.kernels import flash

F32 = dict(rtol=2e-5, atol=2e-5)        # tests/test_flash.py's forward bound
GRAD = dict(rtol=3e-5, atol=3e-5)       # and its gradient bound
BF16_ABS = 0.05                         # its bf16 bound against the f32 oracle


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _qkv(B, H, KV, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32))


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


# tests/test_flash.py:18-22: GQA 2:1, MHA with rectangular blocks, MQA;
# and Nemotron-4 340B's head dim 192 (G = 12 there, 3 here)
SHAPES = [(1, 4, 2, 128, 32, 32, 32), (2, 2, 2, 256, 16, 64, 128),
          (1, 8, 1, 128, 64, 64, 32), (1, 6, 2, 128, 192, 64, 64)]

# (window, head dim) of the gradient tests: the window cases at hd 32, as
# tests/test_flash.py runs them, and again at hd 192
GRAD_CASES = [pytest.param(None, 32, id="None"), pytest.param(48, 32, id="48"),
              pytest.param(None, 192, id="None-hd192"),
              pytest.param(48, 192, id="48-hd192")]


@pytest.mark.parametrize("chunk", [flash.PLAIN_CHUNK, 32])
@pytest.mark.parametrize("B,H,KV,S,hd,bq,bk", SHAPES)
def test_forward_matches_pallas_and_oracle(B, H, KV, S, hd, bq, bk, chunk):
    q, k, v = _qkv(B, H, KV, S, hd)
    want = np.asarray(jflash.flash_attention(*_j(q, k, v), bq=bq, bk=bk))
    got = flash.flash_attention_plain(*_t(q, k, v), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(flash.flash_ref(*_t(q, k, v)).numpy(),
                               np.asarray(jflash.flash_ref(*_j(q, k, v))), **F32)
    # the wrappers take the plain version for CPU tensors
    np.testing.assert_allclose(flash.flash_attention(*_t(q, k, v)).numpy(),
                               want, **F32)


@pytest.mark.parametrize("chunk", [flash.PLAIN_CHUNK, 32])
@pytest.mark.parametrize("window", [32, 64, 96])
def test_sliding_window_matches_pallas(window, chunk):
    """With 32-wide chunks the chunks before the window are fully masked and
    come first: the finite NEG_INF must wipe what they add."""
    q, k, v = _qkv(1, 4, 2, 256, 32, seed=1)
    want = np.asarray(jflash.flash_attention(*_j(q, k, v), window=window,
                                             bq=32, bk=32))
    got = flash.flash_attention_plain(*_t(q, k, v), window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(
        flash.flash_ref(*_t(q, k, v), window=window).numpy(),
        np.asarray(jflash.flash_ref(*_j(q, k, v), window=window)), **F32)


def test_bf16_within_reference_bound():
    q, k, v = _qkv(1, 2, 2, 128, 32, seed=2)
    oracle = np.asarray(jflash.flash_ref(*_j(q, k, v)))
    for chunk in (flash.PLAIN_CHUNK, 32):
        got = flash.flash_attention_plain(*_t(q, k, v, dtype=torch.bfloat16),
                                          chunk=chunk)
        assert got.dtype == torch.bfloat16
        assert float(np.abs(got.float().numpy() - oracle).max()) < BF16_ABS
    pal = np.asarray(jflash.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                                            bq=64, bk=64).astype(jnp.float32))
    assert float(np.abs(pal - oracle).max()) < BF16_ABS


@pytest.mark.parametrize("window", [None, 48])
def test_lse_matches_pallas_stats(window):
    q, k, v = _qkv(1, 4, 2, 128, 32, seed=3)
    o_j, lse_j = jflash._fwd_with_stats(*_j(q, k, v), window, 32, 32)
    o, lse = flash.flash_fwd_with_stats(*_t(q, k, v), window)
    assert lse.shape == (1, 2, 2, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **F32)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j).reshape(o.shape),
                               **F32)


@pytest.mark.parametrize("chunk", [flash.PLAIN_CHUNK, 32])
@pytest.mark.parametrize("window,hd", GRAD_CASES)
def test_gradients_match_pallas_custom_vjp(window, hd, chunk):
    """dq, dk, dv: autograd through the plain version against jax.grad of
    the reference's flash_attention_diff (its block-skipping backward
    kernels in interpret mode)."""
    q, k, v = _qkv(1, 4, 2, 128, hd, seed=4)
    do = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jflash.flash_attention_diff(
        *a, window, 32, 32) * do), (0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = flash.flash_attention_plain(tq, tk, tv, window, chunk=chunk)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)
    # flash_attention_diff on CPU tensors is the same autograd path
    tq2, tk2, tv2 = (t.requires_grad_() for t in _t(q, k, v))
    out2 = flash.flash_attention_diff(tq2, tk2, tv2, window)
    got2 = torch.autograd.grad((out2 * torch.from_numpy(do)).sum(),
                               (tq2, tk2, tv2))
    for g, w in zip(got2, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


@pytest.mark.parametrize("chunk", [flash.PLAIN_CHUNK, 32])
@pytest.mark.parametrize("window,hd", GRAD_CASES)
def test_backward_plain_matches_pallas_backward(window, hd, chunk):
    """The plain version of the two backward kernels, on their inputs (the
    forward's lse, delta = rowsum(dO o)), against the reference's backward
    kernels in interpret mode on the same inputs; the CPU wrappers run it."""
    q, k, v = _qkv(1, 4, 2, 128, hd, seed=6)
    do = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    jq, jk, jv = _j(q, k, v)
    o_j, lse_j = jflash._fwd_with_stats(jq, jk, jv, window, 32, 32)
    want = jflash._fa_bwd(window, 32, 32, (jq, jk, jv, o_j, lse_j),
                          jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    o = torch.from_numpy(np.asarray(o_j)).reshape(tq.shape)
    lse = torch.from_numpy(np.asarray(lse_j))
    delta = flash.flash_delta(o, tdo)
    got = flash.flash_bwd_plain(tq, tk, tv, tdo, lse, delta, window,
                                chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)
    kernels.reset_launches()
    dq = flash.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, window)
    dk, dv = flash.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, window)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)
    assert flash.LAUNCHES == {k: 0 for k in flash.LAUNCHES}


def test_plain_matches_model_chunked_attention():
    """The plain version is the reference model's chunked attention, in the
    kernel layout (as tests/test_flash.py:46-56 holds the Pallas kernel)."""
    q, k, v = _qkv(1, 4, 2, 256, 32, seed=7)
    want = np.asarray(jnp_chunked(*[jnp.asarray(x.transpose(0, 2, 1, 3))
                                    for x in (q, k, v)], None, None, 64, 64))
    got = flash.flash_attention_plain(*_t(q, k, v), chunk=64)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3), want,
                               rtol=3e-5, atol=3e-5)


def test_strided_views_and_no_launch_on_cpu():
    """The model hands the kernels transposed (B, S, H, hd) views; on CPU
    tensors nothing launches, and the launch entry points refuse them."""
    q, k, v = _qkv(1, 4, 2, 128, 64, seed=8)
    tq, tk, tv = _t(q, k, v)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (tq, tk, tv)]
    kernels.reset_launches()
    np.testing.assert_allclose(flash.flash_attention(*views).numpy(),
                               flash.flash_attention(tq, tk, tv).numpy(),
                               rtol=1e-6, atol=1e-6)
    flash.flash_attention_diff(*views, 16)
    flash.flash_fwd_with_stats(*views)
    assert flash.LAUNCHES == {k: 0 for k in flash.LAUNCHES}
    assert set(flash.LAUNCHES) <= set(kernels.launches())
    with pytest.raises(ValueError, match="CUDA"):
        flash._launch_fwd(tq, tk, tv, None, stats=False)
    with pytest.raises(ValueError):
        flash.flash_attention(tq, tk[:, :, :64], tv)
    with pytest.raises(ValueError):
        flash.flash_attention(tq[:, :3], tk, tv)
    # a last chunk shorter than the others, as the kernels' last tile
    np.testing.assert_allclose(
        flash.flash_attention_plain(tq, tk, tv, 40, chunk=96).numpy(),
        flash.flash_ref(tq, tk, tv, 40).numpy(), **F32)
    with pytest.raises(ValueError):
        flash._window(0)


def test_has_kernel_names_the_built_head_dims():
    """``has_kernel`` is the one decision: the wrappers and, on the card,
    the model's long branch refuse the head dims it rejects.  The kernels
    are built for 64, 128 and 192, which covers every config of the port
    that has attention (Nemotron-4 340B's 18432 / 96 is the 192)."""
    assert flash.KERNEL_HEAD_DIMS == (64, 128, 192)
    assert all(flash.has_kernel(hd) for hd in flash.KERNEL_HEAD_DIMS)
    assert not any(flash.has_kernel(hd) for hd in (32, 80, 96, 256))
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        if cfg.family != "ssm":
            assert flash.has_kernel(cfg.resolved_head_dim), arch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kname", flash.KERNELS)
def test_every_instance_fits_a_block_of_shared_memory(kname, dtype):
    """Each kernel instance's shared memory, as the host counts it (the
    card checks the kernel's own count against it at the first launch), at
    every built head dim: under the 227 KB a block may use (the f32 dK/dV
    at hd 192, four (64, 193) f32 tiles and two (64, 65) score tiles, by
    1,024 bytes)."""
    got = [flash.smem_bytes(kname, dtype, hd) for hd in flash.KERNEL_HEAD_DIMS]
    assert all(0 < b <= flash.SMEM_LIMIT for b in got), got
    with pytest.raises(ValueError):
        flash.smem_bytes("flash", dtype, 64)
    with pytest.raises(TypeError):
        flash.smem_bytes(kname, torch.float16, 64)


# The bf16 backward's shared memory a block: up to hd 128 one warpgroup's
# tiles (unchanged since the kernels were written); at hd 192 two
# warpgroups' (Q and dO, or K and V, three stages of the other two, lse and
# delta rows for dK/dV, and the 64 x 64 f32 swap), under the 227 KB a block
# may use.
BWD_SMEM = [("flash_bwd_dq", 64, 50176), ("flash_bwd_dq", 128, 99328),
            ("flash_bwd_dq", 192, 214016), ("flash_bwd_dkv", 64, 51200),
            ("flash_bwd_dkv", 128, 100352), ("flash_bwd_dkv", 192, 215552)]


@pytest.mark.parametrize("kname,hd,want", BWD_SMEM)
def test_bf16_backward_shared_memory_is_pinned(kname, hd, want):
    got = flash.smem_bytes(kname, torch.bfloat16, hd)
    assert got == want <= flash.SMEM_LIMIT
    assert flash.bwd_warpgroups(hd) == (2 if hd == 192 else 1)
    assert flash.bwd_stages(hd) == (3 if hd == 192 else 2)


# The bf16 forward's shared memory a block: up to hd 128 one warpgroup's Q
# tile and three K/V stages (unchanged since the kernels were written); at
# hd 192 two consumers' Q tiles, three K/V stages and the warp-specialised
# block's eight mbarriers (full and empty a stage, and Q's two).
FWD_SMEM = [(64, 58368), (128, 115712), (192, 197696)]


@pytest.mark.parametrize("hd,want", FWD_SMEM)
def test_bf16_forward_shared_memory_is_pinned(hd, want):
    for kname in ("flash_fwd", "flash_fwd_stats"):
        assert flash.smem_bytes(kname, torch.bfloat16, hd) == want
    assert want <= flash.SMEM_LIMIT
    assert flash.fwd_warpgroups(hd) == (2 if hd == 192 else 1)
    assert flash.fwd_specialised(hd) == (hd == 192)
    assert flash.fwd_threads(hd) == (384 if hd == 192 else 128)


def test_forward_register_split_is_the_kernels():
    """The warp-specialised forward's setmaxnreg values: the host's
    constants are the ones csrc/flash.cu names, multiples of 8 in [24, 256]
    (setmaxnreg's rule), and the producer warpgroup and the two consumers
    fit in the SM's 65,536 registers together."""
    import pathlib
    src = (pathlib.Path(flash.__file__).parent / "csrc" / "flash.cu").read_text()
    for name in ("FWD_PRODUCER_REGS", "FWD_CONSUMER_REGS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(flash, name), name
        assert getattr(flash, name) % 8 == 0 and 24 <= getattr(flash, name) <= 256
    consumers = flash.fwd_threads(192) - 128
    assert 128 * flash.FWD_PRODUCER_REGS + consumers * flash.FWD_CONSUMER_REGS <= 65536


def test_bwd_inputs_start_rows_on_16_bytes():
    """The bf16 backward copies rows in 16-byte pieces: the wrapper passes
    an aligned view as it is and copies one that is not."""
    buf = torch.arange(2 * 3 * 64 * 128 + 8, dtype=torch.float32).to(
        torch.bfloat16)
    t = buf[:-8].view(2, 3, 64, 128)
    assert flash._rows16(t).data_ptr() == t.data_ptr()
    view = t.transpose(1, 2).contiguous().transpose(1, 2)   # model layout
    assert flash._rows16(view).data_ptr() == view.data_ptr()
    shifted = buf[1:-7].view(2, 3, 64, 128)                 # 2 bytes off
    got = flash._rows16(shifted)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, shifted)
    odd = torch.zeros((1, 2, 8, 136), dtype=torch.bfloat16)[..., :128]
    assert odd.stride(2) % 8 == 0
    assert flash._rows16(odd).data_ptr() == odd.data_ptr()
    odd = torch.zeros((1, 2, 8, 132), dtype=torch.bfloat16)[..., :128]
    got = flash._rows16(odd)                                # 264-byte rows
    assert got.stride(2) == 128 and torch.equal(got, odd)


def test_ptxas_report_is_parsed():
    """The build keeps nvcc's -Xptxas=-v output; the card run reads each
    kernel's registers, spills and stack from it."""
    from repro_torch.kernels import build
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_"
        "bwd_dq_tc_kernelILi128EEEvPK13__nv_bfloat16' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_"
        "bwd_dq_tc_kernelILi128EEEvPK13__nv_bfloat16\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 8 bytes "
        "cumulative stack size, 560 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, 1024 bytes smem, 360 bytes "
        "cmem[0]\n")
    rep = build.parse_ptxas(log)
    assert rep == {
        "_ZN12_GLOBAL__N_122flash_bwd_dq_tc_kernelILi128EEEvPK13__nv_bfloat16":
            dict(stack=8, spill_stores=4, spill_loads=12, registers=255,
                 smem=0),
        "_Z3fooPf": dict(stack=0, spill_stores=0, spill_loads=0,
                         registers=32, smem=1024)}


def test_ptxas_notes_are_collected_by_kernel():
    """ptxas's coded notes (a serialized wgmma, an ignored setmaxnreg) land
    in the ``notes`` of the kernel they name, else of the kernel being
    compiled; a kernel without one has no ``notes``, and the card run
    fails on any note of a bf16 flash instance."""
    from repro_torch.kernels import build
    ws = "_ZN12_GLOBAL__N_119flash_fwd_ws_kernelILi192ELb0EEEv11CUtensorMap"
    tc = "_ZN12_GLOBAL__N_119flash_fwd_tc_kernelILi128ELb1EEEvPK13__nv_bfloat16"
    log = (
        f"ptxas info    : Compiling entry function '{ws}' for 'sm_90a'\n"
        "ptxas info    : (C7508) Potential Performance Loss: setmaxnreg "
        "ignored; unable to determine register count at entry.\n"
        f"ptxas info    : Function properties for {ws}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 560 bytes "
        "cmem[0]\n"
        f"ptxas info    : Compiling entry function '{tc}' for 'sm_90a'\n"
        "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to wgmma pipeline crossing function "
        f"boundary at a function call in the function '{tc}'\n"
        f"ptxas info    : Function properties for {tc}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 238 registers, 560 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Used 32 registers, 360 bytes cmem[0]\n")
    rep = build.parse_ptxas(log)
    assert rep[ws]["registers"] == 168 and rep[tc]["registers"] == 238
    assert rep[ws]["notes"] == [
        "C7508 Potential Performance Loss: setmaxnreg ignored; unable to "
        "determine register count at entry."]
    assert [n[:5] for n in rep[tc]["notes"]] == ["C7520"]
    assert "notes" not in rep["_Z3fooPf"]
    stray = build.parse_ptxas("ptxas info    : (C7510) Potential "
                              "Performance Loss: wgmma serialized\n")
    assert stray == {"": {"notes": ["C7510 Potential Performance Loss: "
                                    "wgmma serialized"]}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_check_sees_one_key_at_the_window_edge(dtype):
    """The element-wise kernel-vs-plain check passes the plain output
    against itself and fails it with one key fewer at each row's window
    edge (the check the card runs on every flash kernel)."""
    q, k, v = _t(*_qkv(1, 4, 2, 256, 64, seed=9), dtype=dtype)
    tol = flash.KERNEL_TOL[dtype]
    o, lse = flash.flash_attention_plain(q, k, v, 40, chunk=64, return_lse=True)
    assert flash.kernel_mismatch(o, o, *tol) == 0.0
    short, short_lse = flash.flash_attention_plain(q, k, v, 39, chunk=64,
                                                   return_lse=True)
    assert flash.kernel_mismatch(short, o, *tol) > 1
    assert flash.kernel_mismatch(short_lse, lse,
                                 *flash.KERNEL_TOL[torch.float32]) > 1
    # a zero row is held exactly
    z = torch.zeros((2, 8))
    assert flash.kernel_mismatch(z, z, *tol) == 0.0
    assert flash.kernel_mismatch(z + 1e-30, z, *tol) == float("inf")



def _tc_bwd_emulated(q, k, v, do, lse, delta, window, split: bool):
    """The bf16 backward kernels' operand rounding, in torch: S and dP from
    the bf16 inputs in f32, p and dS handed to dV = P^T dO, dK = dS^T Q and
    dQ = dS K either as a bf16 hi + lo pair (``split``: two products into
    one f32 sum, as the kernels do) or rounded to bf16 once
    (FlashAttention-2's rounding).  dq, dk, dv in f32, before the kernels'
    one rounding to bf16."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qf = q.float().reshape(B, KV, G, S, hd)
    dof = do.float().reshape(B, KV, G, S, hd)
    kf, vf = k.float(), v.float()
    lse = lse.float().reshape(B, KV, G, S, 1)
    delta = delta.float().reshape(B, KV, G, S, 1)
    pos = torch.arange(S)
    keep = flash._keep(pos[:, None], pos[None, :], window)
    s = torch.einsum("bkgsh,bkth->bkgst", qf, kf) * scale
    p = torch.where(keep, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bkgsh,bkth->bkgst", dof, vf)
    ds = p * (dp - delta) * scale

    def parts(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    dq = sum(torch.einsum("bkgst,bkth->bkgsh", a, kf) for a in parts(ds))
    dk = sum(torch.einsum("bkgst,bkgsh->bkth", a, qf) for a in parts(ds))
    dv = sum(torch.einsum("bkgst,bkgsh->bkth", a, dof) for a in parts(p))
    return dq.reshape(B, H, S, hd), dk, dv


@pytest.mark.parametrize("window", [None, 100])
def test_split_operands_hold_the_plain_backward(window):
    """The bf16 backward kernels' numerics on the qwen3 smoke heads (4 query
    heads, 2 kv heads) at Qwen3's head dim 128, element by element against
    flash_bwd_plain at KERNEL_TOL[bfloat16].  With p and dS split into bf16
    hi + lo, dq, dk and dv hold after their rounding to bf16, and before it
    sit far inside half the allowance; a single bf16 rounding of p and dS
    (FlashAttention-2's) takes more than half of it before the outputs'
    own rounding.  (After that rounding both variants show one-step flips
    of about half the allowance, so the comparison that separates them is
    the f32 one.)"""
    q, k, v = _t(*_qkv(1, 4, 2, 256, 128, seed=10), dtype=torch.bfloat16)
    do = _t(np.random.default_rng(11).normal(size=q.shape).astype(np.float32),
            dtype=torch.bfloat16)[0]
    tol = flash.KERNEL_TOL[torch.bfloat16]
    o, lse = flash.flash_fwd_with_stats(q, k, v, window)
    delta = flash.flash_delta(o, do)
    want = flash.flash_bwd_plain(q, k, v, do, lse, delta, window)
    # the same plain math on the same values, before the rounding to bf16
    want32 = flash.flash_bwd_plain(q.float(), k.float(), v.float(),
                                   do.float(), lse, delta, window)
    worst, worst32 = {}, {}
    for split in (True, False):
        got = _tc_bwd_emulated(q, k, v, do, lse, delta, window, split)
        worst32[split] = [flash.kernel_mismatch(g, w, *tol)
                          for g, w in zip(got, want32)]
        worst[split] = [flash.kernel_mismatch(g.to(torch.bfloat16), w, *tol)
                        for g, w in zip(got, want)]
    print(f"\nworst |emulated - plain| / allowance (dq, dk, dv), window "
          f"{window}: hi + lo {worst32[True]} in f32, {worst[True]} in "
          f"bf16; single rounding {worst32[False]} in f32, {worst[False]} "
          f"in bf16")
    assert max(worst[True]) <= 1, worst
    assert max(worst32[True]) <= 0.5, worst32
    assert min(worst32[False]) > 0.5, worst32
