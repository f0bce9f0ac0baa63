"""The assigned input-shape sets and their stand-in inputs, the
counterpart of the reference package's ``launch/shapes.py``: the stand-ins
are ``device="meta"`` tensors (shape and dtype, no storage), as the
reference's are ``jax.ShapeDtypeStruct``s.

LM shapes (per the assignment):
    train_4k     seq 4096,    global_batch 256   (training)
    prefill_32k  seq 32768,   global_batch 32    (inference prefill)
    decode_32k   seq 32768,   global_batch 128   (decode: 1 new token, KV=32k)
    long_500k    seq 524288,  global_batch 1     (long-context decode;
                 SSM/hybrid only: quadratic-attention archs skip)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.uses_ssm:
        return ("pure full-attention arch: 500k-token decode requires "
                "sub-quadratic attention (run for SSM/hybrid only)")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, batch: Optional[int] = None,
                ac=None) -> dict:
    """Meta stand-ins for every model input of this cell, with ``batch``
    rows (default: the shape's global batch); a decode cell's cache is
    ``ac``'s rank's (``model.cache_shapes``)."""
    B = shape.global_batch if batch is None else batch
    S = shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs = {}
        s_text = S
        if cfg.vision_tokens:
            s_text = S - cfg.vision_tokens
            specs["vision_embeds"] = _meta((B, cfg.vision_tokens, cfg.d_model),
                                           getattr(torch, cfg.compute_dtype))
            if cfg.rope == "mrope":
                specs["positions"] = _meta((3, B, S), i32)
        if cfg.n_codebooks > 1:
            specs["tokens"] = _meta((B, cfg.n_codebooks, s_text), i32)
        else:
            specs["tokens"] = _meta((B, s_text), i32)
        return specs
    # decode: one new token against a cache of length S
    tok_shape = (B, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B,)
    return {
        "tokens": _meta(tok_shape, i32),
        "position": _meta((B,), i32),
        "cache": {n: _meta(s, getattr(torch, dt))
                  for n, (s, dt) in MD.cache_shapes(cfg, B, S, ac).items()},
    }
