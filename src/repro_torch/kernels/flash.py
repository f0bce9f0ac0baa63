"""Causal GQA flash attention: the forward, and its gradient.

CUDA tensors run the hand-written kernels of ``csrc/flash.cu``, which
replace the TPU kernels of ``repro/kernels/flash.py`` (``_flash_kernel``,
``_flash_fwd_stats_kernel``, ``_flash_bwd_dq_kernel``,
``_flash_bwd_dkv_kernel``) at head dims 64, 128 and 192 and skip every
fully masked (q tile, kv tile) pair; in bf16 every tile product runs on
the tensor cores as ``wgmma`` (the forward's softmax in registers between
its two products, the backward's p and dS split into bf16 hi + lo pairs;
see the note in ``flash.cu``).  The bf16 forward at hd 192 is
warp-specialised and persistent (a block an SM): a producer warpgroup
copies the tiles by TMA (a tensor map of q, k and v each, encoded at
every launch) and two consumer warpgroups take turns on the tensor
cores.
CPU tensors run the plain versions: :func:`flash_attention_plain`,
the chunked online softmax of the reference's ``models/layers.py``
``_flash_attention`` in the kernels' layout and numerics, for the two
forward kernels (its backward is torch autograd), and
:func:`flash_bwd_plain`, the reference backward's math on the kernels'
inputs, for dq and dk/dv.  :func:`flash_ref` is the dense oracle.

Layout: q ``(B, H, S, hd)``, k and v ``(B, KV, S, hd)``; query head
``h = kv * G + g`` reads kv head ``kv`` (``G = H // KV``).  Attention is
causal, optionally within a sliding window (keys ``kp`` with
``qp - window < kp <= qp``), scaled by ``1 / sqrt(hd)``.  The kernels take
strided views (only hd must be contiguous), so the model's ``(B, S, H, hd)``
activations go in transposed without a copy.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30

# Chunk of the plain version: the reference model's chunk_q = chunk_kv.
PLAIN_CHUNK = 1024
# The kernels' kv tile, at every head dim and in both dtypes.  The plain
# forward run at this chunk rounds p at the same running maxima as the
# kernels (a row's numerics do not depend on the q tile).
KERNEL_TILE = 64

# Head dims the kernels are instantiated for (Qwen3 128, TinyLlama 64,
# Nemotron-4 340B's 18432 / 96 = 192): every head dim of the configs in
# ``repro_torch.configs`` that has attention.
KERNEL_HEAD_DIMS = (64, 128, 192)

# Shared memory a block may use on the H100 (227 KB), and what each kernel
# instance takes (smem_bytes), as csrc/flash.cu counts it: a bf16 forward
# block is fwd_warpgroups(hd) warpgroups on as many 64-row q tiles and
# streams K and V through FWD_STAGES stages (at hd 192 with a full and an
# empty mbarrier a stage and two for Q, 8 bytes each); a bf16 backward
# block holds one 64-row tile of two tensors (Q and dO for dQ, K and V for
# dK/dV), streams the other two through bwd_stages(hd) stages and, with
# bwd_warpgroups(hd) = 2, swaps halves of its 64 x 64 f32 scores between
# the two warpgroups.
SMEM_LIMIT = 232448
FWD_STAGES = 3
STAGES = 2
WIDE_STAGES = 3
KERNELS = ("flash_fwd", "flash_fwd_stats", "flash_bwd_dq", "flash_bwd_dkv")
# Registers a thread of the warp-specialised bf16 forward's (hd 192)
# producer warpgroup and of each consumer warpgroup, as its setmaxnreg sets
# them (csrc/flash.cu names the same two constants); ptxas reports the
# kernel's count at entry.
FWD_PRODUCER_REGS = 24
FWD_CONSUMER_REGS = 240


def fwd_warpgroups(hd: int) -> int:
    """Warpgroups of a bf16 forward block that own 64 query rows each
    (csrc/flash.cu ``fwd_wgs``)."""
    return 2 if hd > 128 else 1


def fwd_specialised(hd: int) -> bool:
    """Whether the bf16 forward block at ``hd`` is warp-specialised, with
    a producer warpgroup besides its fwd_warpgroups(hd) (csrc/flash.cu
    ``fwd_ws``)."""
    return hd > 128


def fwd_threads(hd: int) -> int:
    """Threads of a bf16 forward block (csrc/flash.cu ``fwd_threads``)."""
    return 128 * (fwd_warpgroups(hd) + fwd_specialised(hd))


def bwd_warpgroups(hd: int) -> int:
    """Warpgroups of a bf16 backward block, dQ and dK/dV (csrc/flash.cu
    ``bwd_wgs``): at hd 192 two, which split each tile's products."""
    return 2 if hd > 128 else 1


def bwd_stages(hd: int) -> int:
    """Stages of a bf16 backward block's ring (csrc/flash.cu ``bwd_stages``):
    three where two warpgroups pipeline the steps one deep (hd 192)."""
    return WIDE_STAGES if bwd_warpgroups(hd) > 1 else STAGES


def smem_bytes(kname: str, dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared memory a block of the ``kname`` kernel (one of
    :data:`KERNELS`) takes for ``dtype`` at head dim ``hd``, in bytes: the
    host's count of csrc/flash.cu's ``fwd_bytes``, ``dq_bytes`` and
    ``dkv_bytes``, which :func:`kernel_info` checks against the kernel's
    own at each instance's first launch."""
    t = KERNEL_TILE
    if kname not in KERNELS:
        raise ValueError(f"unknown flash kernel {kname!r}")
    if dtype == torch.bfloat16:
        if kname.startswith("flash_fwd"):
            bars = 8 * (2 * FWD_STAGES + 2) if fwd_specialised(hd) else 0
            tiles = 2 * (fwd_warpgroups(hd) + 2 * FWD_STAGES) * t * hd
            return tiles + 1024 + bars
        tiles = 2 * (2 + 2 * bwd_stages(hd)) * t * hd + 1024
        swap = 4 * t * t if bwd_warpgroups(hd) > 1 else 0   # f32 scores
        if kname == "flash_bwd_dq":
            return tiles + swap
        return tiles + 4 * 2 * bwd_stages(hd) * t + swap   # and lse, delta
    if dtype != torch.float32:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got "
                        f"{dtype}")

    def tile(rows, cols):                 # f32, one padding column
        return 4 * rows * (cols + 1)
    if kname.startswith("flash_fwd"):
        return 2 * tile(t, hd) + tile(t, t)
    if kname == "flash_bwd_dq":
        return 3 * tile(t, hd) + tile(t, t)
    return 4 * tile(t, hd) + 2 * tile(t, t) + 4 * 2 * t


def has_kernel(hd: int) -> bool:
    """Whether the kernels are built for head dim ``hd``: the one place
    that decides it, for the wrappers and for the model's long branch, which
    both refuse other head dims on CUDA tensors."""
    return hd in KERNEL_HEAD_DIMS


# A kernel's output against its plain version on the same inputs, element
# by element (kernel_mismatch): |kernel - plain| <= rtol |plain| + atol *
# (the largest |plain| of its row).  The forward's plain version runs at
# the kernels' tile (KERNEL_TILE), the backward's (flash_bwd_plain) on the
# kernels' lse and delta, so the two compute the same f32 terms and differ
# by their order.  f32: rows of o, dq, dk, dv (and the lse rows, in both
# dtypes) within 1e-5 relative and 1e-4 of the row's largest entry.  bf16:
# each rounds its f32 result to bf16 once, so the two may sit one bf16 step
# apart, at most 2^-7 of the value; and in the forward, a p term that lies
# at a rounding boundary may round the other way, a step of 2^-8 of that
# term, which atol covers.
KERNEL_TOL = {torch.float32: (1e-5, 1e-4),
              torch.bfloat16: (2.0 ** -7, 2.0 ** -8)}

# Kernel launches since the last reset_launches(), by kernel.  One call of a
# wrapper launches each of its kernels once.
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention takes q (B, H, S, hd) and k, v "
                         f"(B, KV, S, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, KV, S, hd) = "
                         f"{(B, KV, S, hd)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} query heads must be a multiple of KV={KV} "
                         f"kv heads")
    return B, H, KV, S, hd


def _keep(qp: torch.Tensor, kp: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    keep = kp <= qp
    if window is not None:
        keep &= kp > qp - window
    return keep


# --------------------------------------------------------------------------- #
# Dense oracle and the plain version
# --------------------------------------------------------------------------- #
def flash_ref(q, k, v, window: Optional[int] = None) -> torch.Tensor:
    """Oracle: q (B, H, S, hd), k/v (B, KV, S, hd) -> (B, H, S, hd), causal,
    as a dense softmax over the masked (S, S) scores."""
    B, H, KV, S, hd = _shapes(q, k, v)
    qg = q.reshape(B, KV, H // KV, S, hd)
    s = torch.einsum("bkgsh,bkth->bkgst", qg, k).float() / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    keep = _keep(pos[:, None], pos[None, :], window)
    s = torch.where(keep, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,bkth->bkgsh", w, v).reshape(B, H, S, hd)


def flash_attention_plain(q, k, v, window: Optional[int] = None,
                          chunk: int = PLAIN_CHUNK,
                          return_lse: bool = False):
    """The chunked online-softmax attention of the reference model
    (``layers._flash_attention``: every chunk pair, masked ones included) in
    the kernels' layout and numerics: f32 scores from exact products, p
    rounded to v's dtype before p.V, f32 sums, output in q's dtype.
    ``return_lse`` also returns the f32 log-sum-exp rows (B, KV, G, S).
    S need not be a multiple of ``chunk`` (the last chunk is shorter, as the
    kernels' last tile).  Differentiable by torch autograd; the plain
    version of both forward kernels."""
    B, H, KV, S, hd = _shapes(q, k, v)
    G = H // KV
    c = min(chunk, S)
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, KV, G, S, hd)
    kf, vf = k.float(), v.float()
    pos = torch.arange(S, device=q.device)
    outs, lses = [], []
    for q0 in range(0, S, c):
        qr = slice(q0, q0 + c)
        qb = qf[:, :, :, qr]
        n = qb.shape[3]
        m = qf.new_full((B, KV, G, n), NEG_INF)
        l = qf.new_zeros((B, KV, G, n))
        acc = qf.new_zeros((B, KV, G, n, hd))
        for k0 in range(0, S, c):
            kr = slice(k0, k0 + c)
            s = torch.einsum("bkgsh,bkth->bkgst", qb, kf[:, :, kr]) * scale
            s = torch.where(_keep(pos[qr, None], pos[None, kr], window), s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,bkth->bkgsh", p.to(v.dtype).float(), vf[:, :, kr])
            m = m_new
        den = l.clamp_min(1e-30)
        outs.append(acc / den[..., None])
        lses.append(m + torch.log(den))
    o = torch.cat(outs, dim=3).reshape(B, H, S, hd).to(q.dtype)
    return (o, torch.cat(lses, dim=3)) if return_lse else o


def kernel_mismatch(got, want, rtol: float, atol: float) -> float:
    """The largest ``|got - want| / (rtol |want| + atol rowmax |want|)``,
    rows along the last axis: at most 1 where ``got`` holds to ``want``."""
    w = want.float()
    d = (got.float() - w).abs()
    allowed = rtol * w.abs() + atol * w.abs().amax(dim=-1, keepdim=True)
    return float(torch.where(d == 0, 0.0, d / allowed).max())


def flash_bwd_plain(q, k, v, do, lse, delta, window: Optional[int] = None,
                    chunk: int = PLAIN_CHUNK):
    """dq, dk, dv from the forward's lse rows and delta = rowsum(dO o): the
    reference backward's math (``_fa_bwd``: p = exp(s - lse) under the
    mask, every product in f32, dO and v upcast), a chunk of query rows at a
    time, with dk and dv summed over each kv head's G query heads in f32 and
    rounded once, as the kernels do.  The plain version of the two backward
    kernels, on their inputs."""
    B, H, KV, S, hd = _shapes(q, k, v)
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, KV, G, S, hd)
    dof = do.float().reshape(B, KV, G, S, hd)
    kf, vf = k.float(), v.float()
    lse = lse.float().reshape(B, KV, G, S)
    delta = delta.float().reshape(B, KV, G, S)
    kp = torch.arange(S, device=q.device)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, S, chunk):
        r = slice(q0, q0 + chunk)
        s = torch.einsum("bkgsh,bkth->bkgst", qf[:, :, :, r], kf) * scale
        keep = _keep(kp[r, None], kp[None, :], window)
        p = torch.where(keep, torch.exp(s - lse[..., r, None]), 0.0)
        dp = torch.einsum("bkgsh,bkth->bkgst", dof[:, :, :, r], vf)
        ds = p * (dp - delta[..., r, None]) * scale
        dq[:, :, :, r] = torch.einsum("bkgst,bkth->bkgsh", ds, kf)
        dk += torch.einsum("bkgst,bkgsh->bkth", ds, qf[:, :, :, r])
        dv += torch.einsum("bkgst,bkgsh->bkth", p, dof[:, :, :, r])
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check_inputs(q, k, v, what: str):
    shapes = _shapes(q, k, v)
    hd = shapes[-1]
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{what}: q, k and v must be on one device, got "
                             f"{q.device}, {k.device}, {v.device}")
    if q.device.type != "cuda":
        raise ValueError(f"{what}: expected CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not has_kernel(hd):
        raise ValueError(f"{what}: the kernels are built for head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    return shapes


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a contiguous last axis (a copy only when it has none)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """:func:`_rows`, and rows that start on 16 bytes (an aligned pointer,
    (batch, head, sequence) strides of whole 16-byte pieces), as the bf16
    kernels' 16-byte copies need; a copy only when they do not."""
    t = _rows(t)
    if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                for s in t.stride()[:3]):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _strides(*ts: torch.Tensor):
    """The (batch, head, sequence) strides of each tensor, as the C array
    the kernels read."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _window(window: Optional[int]) -> int:
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return int(window)


def _launch_fwd(q, k, v, window: Optional[int],
                stats: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    from repro_torch.kernels import build
    kname = "flash_fwd_stats" if stats else "flash_fwd"
    B, H, KV, S, hd = _check_inputs(q, k, v, kname)
    rows = _rows16 if q.dtype == torch.bfloat16 else _rows
    q, k, v = rows(q), rows(k), rows(v)
    _confirm(kname, q.dtype, hd)
    o = torch.empty_like(q)           # q's layout: a view of the same order
    lse = (torch.empty((B, KV, H // KV, S), dtype=torch.float32,
                       device=q.device) if stats else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.library("flash").flash_fwd_launch(
            _DTYPE_CODE[q.dtype], hd, int(stats), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr() if stats else None,
            _strides(q, k, v, o), B, H, KV, S, _window(window),
            1.0 / math.sqrt(hd), stream)
    build.check("flash", rc, f"{kname} launch")
    LAUNCHES[kname] += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, what: str):
    B, H, KV, S, hd = _check_inputs(q, k, v, what)
    if tuple(lse.shape) != (B, KV, H // KV, S) or delta.numel() != B * H * S:
        raise ValueError(f"{what}: lse and delta must hold (B, KV, G, S) = "
                         f"{(B, KV, H // KV, S)} rows, got {tuple(lse.shape)}, "
                         f"{tuple(delta.shape)}")
    q, k, v, do = (_rows16(t) for t in (q, k, v, do.to(q.dtype)))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _confirm(what, q.dtype, hd)
    return (q, k, v, do, lse, delta), (B, H, KV, S, hd)


def flash_bwd_dq(q, k, v, do, lse, delta, window: Optional[int] = None):
    """dq (TPU row 11), from the forward's lse and delta = rowsum(dO o)
    (:func:`flash_delta`).  A CUDA tensor launches ``flash_bwd_dq``; a CPU
    tensor runs :func:`flash_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, window)[0]
    from repro_torch.kernels import build
    (q, k, v, do, lse, delta), (B, H, KV, S, hd) = _bwd_args(
        q, k, v, do, lse, delta, "flash_bwd_dq")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = build.library("flash").flash_bwd_dq_launch(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), _strides(q, k, v, do, dq), B, H, KV, S,
            _window(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    build.check("flash", rc, "flash_bwd_dq launch")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, window: Optional[int] = None):
    """dk, dv (TPU row 12), summed over the G query heads of each kv head
    in f32 inside the kernel and rounded once (the reference rounds each
    head's share to k's dtype before the sum).  A CUDA tensor launches
    ``flash_bwd_dkv``; a CPU tensor runs :func:`flash_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, window)[1:]
    from repro_torch.kernels import build
    (q, k, v, do, lse, delta), (B, H, KV, S, hd) = _bwd_args(
        q, k, v, do, lse, delta, "flash_bwd_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = build.library("flash").flash_bwd_dkv_launch(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do, dk, dv), B,
            H, KV, S, _window(window), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    build.check("flash", rc, "flash_bwd_dkv launch")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def kernel_info(kname: str, dtype: torch.dtype, hd: int) -> Dict[str, int]:
    """The ``kname`` kernel instance for ``dtype`` at head dim ``hd`` on the
    current card: the dynamic shared memory a block that its launch asks
    for (bytes, the kernel's own count) and resident blocks per SM.  Raises
    when that count is not the host's (:func:`smem_bytes`)."""
    from repro_torch.kernels import build
    vals = (ctypes.c_int * 2)()
    build.check("flash", build.library("flash").flash_info(
        KERNELS.index(kname), _DTYPE_CODE[dtype], hd, vals), f"{kname} info")
    want = smem_bytes(kname, dtype, hd)
    if vals[0] != want:
        raise RuntimeError(
            f"{kname} ({dtype}, hd {hd}) asks for {vals[0]} bytes of shared "
            f"memory, the host counted {want}: csrc/flash.cu and "
            f"flash.smem_bytes disagree")
    return {"smem_bytes": vals[0], "blocks_per_sm": vals[1]}


# (kernel, dtype, hd) instances whose shared memory count the kernel has
# confirmed (kernel_info), each once a process.
_CHECKED: set = set()


def _confirm(kname: str, dtype: torch.dtype, hd: int) -> None:
    if (kname, dtype, hd) not in _CHECKED:
        kernel_info(kname, dtype, hd)
        _CHECKED.add((kname, dtype, hd))


def flash_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO o) in f32, (B, H, S): a plain reduction outside the
    kernels, as in the reference."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention(q, k, v, window: Optional[int] = None) -> torch.Tensor:
    """Forward only (TPU row 9): q (B, H, S, hd), k/v (B, KV, S, hd) ->
    (B, H, S, hd) in q's dtype.  A CUDA tensor launches ``flash_fwd``; a
    CPU tensor runs :func:`flash_attention_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    return _launch_fwd(q, k, v, window, stats=False)[0]


def flash_fwd_with_stats(q, k, v, window: Optional[int] = None):
    """The forward that also returns the f32 log-sum-exp rows (B, KV, G, S)
    (TPU row 10; the reference's ``_fwd_with_stats``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window, return_lse=True)
    return _launch_fwd(q, k, v, window, stats=True)


class _FlashAttentionDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = _launch_fwd(q, k, v, window, stats=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = flash_delta(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.window)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.window)
        return dq, dk, dv, None


def flash_attention_diff(q, k, v, window: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention, the same function as
    :func:`flash_attention`.  On CUDA tensors its forward launches
    ``flash_fwd_stats`` (saving o and the f32 lse) and its backward
    ``flash_bwd_dq`` and ``flash_bwd_dkv``.  On CPU tensors it is
    :func:`flash_attention_plain` under autograd."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    return _FlashAttentionDiff.apply(q, k, v, window)
