"""Layers of the port's recon networks, the counterparts of the reference
package's ``nn/modules.py`` in PyTorch idiom: NCHW activations, OIHW
convolution weights, parameters in ``nn.Module`` s drawn from an explicit
``torch.Generator``.

``params_from_reference`` carries a reference parameter tree (nested dicts
of numpy arrays, NHWC/HWIO) into the port's state-dict form.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """"SAME" convolution (the reference's ``conv_general_dilated`` with
    ``padding="SAME"``): x (N, C, H, W), weight (O, C, kh, kw)."""
    kh, kw = weight.shape[-2:]
    ph, pw = _same_pads(x.shape[-2], kh, stride), _same_pads(x.shape[-1], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, weight, bias, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (*pw, *ph)), weight, bias, stride=stride)


def _transpose_pads(k: int, s: int):
    """The reference's ``conv_transpose`` "SAME" padding of the dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """The reference's ``conv_transpose(..., padding="SAME")``: x dilated by
    ``stride``, padded, then correlated with ``weight`` (O, C, kh, kw)
    unflipped.  Output (N, O, H * stride, W * stride)."""
    n, c, h, w = x.shape
    kh, kw = weight.shape[-2:]
    xd = x.new_zeros((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1))
    xd[:, :, ::stride, ::stride] = x
    ph, pw = _transpose_pads(kh, stride), _transpose_pads(kw, stride)
    return F.conv2d(F.pad(xd, (*pw, *ph)), weight, bias)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """x @ weight.T + bias, weight (d_out, d_in) as ``nn.Linear``'s."""
    return F.linear(x, weight, bias)


def norm_groups(ch: int, groups: int = 8) -> int:
    """The reference's group count: ``min(groups, ch)``, lowered until it
    divides ``ch``."""
    g = min(groups, ch)
    while ch % g:
        g -= 1
    return g


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """Group norm over (H, W, C/g) with the biased variance, eps inside the
    rsqrt: x (N, C, H, W)."""
    return F.group_norm(x, norm_groups(x.shape[1], groups), weight, bias, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def avg_pool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k mean over "VALID" windows (a ragged edge is dropped)."""
    return F.avg_pool2d(x, k)


def upsample_nearest(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Each pixel repeated k x k, as a broadcast (its backward is a sum over
    the broadcast axes, with no scattered adds)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, k, w, k).reshape(
        n, c, h * k, w * k)


def count_params(params) -> int:
    """Elements in a module's parameters or in a dict of tensors."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return sum(p.numel() for p in params.values())


class Conv2d(nn.Module):
    """k x k "SAME" convolution, He-normal weights, zero bias."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3,
                 generator: torch.Generator = None):
        super().__init__()
        std = math.sqrt(2.0 / (in_ch * k * k))
        self.weight = nn.Parameter(torch.randn(
            (out_ch, in_ch, k, k), generator=generator) * std)
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        return conv2d(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    def __init__(self, ch: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups)


def params_from_reference(tree) -> dict:
    """A reference parameter tree (nested dicts and lists of arrays, as
    ``unet_init`` / ``ctnet_init`` give them, or a dict of such trees) ->
    the port's state dict: conv ``w`` HWIO -> ``weight`` OIHW, dense ``w``
    (d_in, d_out) -> ``weight`` (d_out, d_in), group norm ``scale`` ->
    ``weight``, ``b`` / ``bias`` -> ``bias``; list entries by index."""
    out = {}

    def leaf(name, a):
        a = np.asarray(a)
        if name == "w":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        return torch.from_numpy(np.array(a, order="C"))

    def walk(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            path = f"{prefix}{k}"
            if isinstance(v, (dict, list, tuple)):
                walk(v, path + ".")
            else:
                name = {"w": "weight", "b": "bias", "scale": "weight",
                        "bias": "bias"}[k]
                out[f"{prefix}{name}"] = leaf(k, v)

    walk(tree, "")
    return out
