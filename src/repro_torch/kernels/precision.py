"""Mixed-precision policy shared by the projector kernel pair.

* **Tiles** — the dominant device-memory streams (the axially convolved
  volume for FP, the sinogram for BP) are cast to the *compute dtype* at
  the kernel boundary (:func:`cast_in`).
* **Weights** — SF footprint weights are always *derived* in float32, then
  rounded to the tile dtype right before the multiply (:func:`cast_like`)
  so both operands match.
* **Accumulation** — every kernel sums in float32 into a float32 output
  buffer; the caller's dtype is restored once, on the final result.

``compute_dtype=None`` means "follow the input's dtype" (f32 in -> f32
tiles, bf16 in -> bf16 tiles + f32 accumulation).
"""
from __future__ import annotations

import torch

# bfloat16 has an 8-bit significand (incl. the hidden bit): one quantization
# step is 2^-8 relative.
BF16_EPS = 2.0 ** -8

# Relative error bound (max-abs error over max-abs reference) of a
# bf16-tile / f32-accumulate projection against the f32 reference.  Tile and
# weight quantization each contribute <= BF16_EPS relative per product and
# the SF weights are non-negative, so errors grow sublinearly under the f32
# accumulation; 12x covers the observed worst case with >2x margin.
BF16_FP_REL_BOUND = 12 * BF16_EPS            # ~= 0.047

# Matched-pair dot-test tolerance at bf16: the forward path quantizes the
# axially convolved volume while the adjoint path quantizes the sinogram, so
# <Ax, y> and <x, A'y> differ by O(BF16_EPS) relative.  5x margin.
BF16_DOT_TOL = 5 * BF16_EPS                  # ~= 0.02

# A kernel against its plain version on the same bf16 tiles (relative, as
# BF16_FP_REL_BOUND).  Both round the tiles and the f32-derived weights to
# bf16 the same way, so they differ only by f32 summation order and by the
# rare weight whose last f32 bit rounds it the other way — far less than
# BF16_FP_REL_BOUND, which covers the quantization itself.
BF16_KERNEL_REL_TOL = 1e-3

_SUPPORTED = ("float32", "bfloat16")
_ALIASES = {"f32": "float32", "fp32": "float32", "bf16": "bfloat16"}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def normalize(compute_dtype):
    """Canonicalize a compute-dtype policy value.

    ``None`` / ``"auto"`` -> ``None`` (follow the input dtype); otherwise the
    canonical dtype name (``"float32"`` | ``"bfloat16"``).  Accepts strings
    and torch dtypes; raises ``ValueError`` for anything outside the
    supported set.  The returned name is what goes into the op-cache key."""
    if compute_dtype is None or compute_dtype == "auto":
        return None
    if isinstance(compute_dtype, str):
        name = _ALIASES.get(compute_dtype, compute_dtype)
    elif isinstance(compute_dtype, torch.dtype):
        name = str(compute_dtype).removeprefix("torch.")
    else:
        raise ValueError(f"bad compute_dtype {compute_dtype!r}")
    if name not in _SUPPORTED:
        raise ValueError(
            f"unsupported compute_dtype {compute_dtype!r}; expected one of "
            f"{_SUPPORTED} (or None/'auto' to follow the input dtype)")
    return name


def resolve(compute_dtype, in_dtype: torch.dtype) -> torch.dtype:
    """The dtype kernel tiles are cast to at the kernel boundary."""
    name = normalize(compute_dtype)
    return in_dtype if name is None else _TORCH[name]


def cast_in(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Cast a kernel input stream to the compute dtype.  No-op on f32."""
    return x if x.dtype == compute_dtype else x.to(compute_dtype)


def cast_like(w: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """Round f32 footprint weights to the streamed tile's dtype and back to
    f32, so a product with the tile equals the kernels' bf16 x bf16 product
    accumulated in f32.  No-op on the f32 path."""
    if tile.dtype == torch.float32:
        return w
    return w.to(tile.dtype).to(torch.float32)
