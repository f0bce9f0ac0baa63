"""``ProjectorSpec`` — the single immutable description of a projection op.

    >>> spec = ProjectorSpec(geom, model="sf", compute_dtype="bf16")
    >>> proj = Projector(spec)
    >>> sino = forward_project(f, spec)

The spec is the op-cache key (``spec.cache_key()``), the admission-bucket
key for batching compatible requests (``spec.bucket_key()``), and the
validation point: bad model/backend/dtype values raise here, once.

Backends: ``"auto"`` follows the input tensor (CUDA tensors go through the
hand-written kernels, CPU tensors through the plain PyTorch reference; a
geometry and model with no kernels run the plain reference on either),
``"cuda"`` demands the kernels (and raises on a CPU tensor), ``"ref"``
always runs the plain reference.  Modes: ``"exact"`` | ``"packed"`` (the
approximate packed cone pair) | ``"auto"`` (packed where its error gate
accepts the geometry); ``kernels/ops.py`` ``resolve_mode`` says which.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Optional, Tuple, TYPE_CHECKING

from repro_torch.core.geometry import CTGeometry

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.kernels.tune import KernelConfig

__all__ = ["ProjectorSpec"]

_MODELS = ("sf", "joseph")
_BACKENDS = ("auto", "cuda", "ref")
_MODES = ("auto", "exact", "packed")


@dataclasses.dataclass(frozen=True, eq=False)
class ProjectorSpec:
    """Frozen, hashable description of one projection operator.

    Fields:
        geom:          scanner geometry (content-hashed — two specs built
                       from equal geometries compare/hash equal even when
                       the geometry objects differ).
        model:         footprint model, ``"sf"`` | ``"joseph"``.
        backend:       ``"auto"`` | ``"cuda"`` | ``"ref"``.
        mode:          ``"auto"`` | ``"exact"`` | ``"packed"``: which pair of
                       the (geometry, model) runs where a packed pair is
                       registered.
        compute_dtype: kernel tile precision, ``"bfloat16"`` | ``"float32"``
                       | None (follow the input dtype); aliases like
                       ``"bf16"`` are canonicalized at construction.
        config:        explicit :class:`~repro_torch.kernels.tune.KernelConfig`
                       pin, or None for the heuristic.
    """

    geom: CTGeometry
    model: str = "sf"
    backend: str = "auto"
    mode: str = "auto"
    compute_dtype: Optional[str] = None
    config: Optional["KernelConfig"] = None

    def __post_init__(self):
        # Late imports: the kernels package imports this module.
        from repro_torch.kernels import precision
        from repro_torch.kernels.tune import KernelConfig
        if not isinstance(self.geom, CTGeometry):
            raise TypeError(
                f"ProjectorSpec.geom must be a CTGeometry, got "
                f"{type(self.geom).__name__}")
        if self.model not in _MODELS:
            raise ValueError(f"unknown projector model {self.model!r}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {_BACKENDS}")
        if self.mode not in _MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected "
                             f"one of {_MODES}")
        if self.config is not None and not isinstance(self.config, KernelConfig):
            raise TypeError(f"config must be a KernelConfig, "
                            f"got {self.config!r}")
        object.__setattr__(self, "compute_dtype",
                           precision.normalize(self.compute_dtype))

    @functools.cached_property
    def resolved_mode(self) -> str:
        """The pair ("exact" | "packed") that dispatch runs for this spec
        (``kernels/ops.py`` ``resolve_mode``), resolved at its first use and
        kept."""
        from repro_torch.kernels.ops import _resolve_mode
        return _resolve_mode(self)

    def replace(self, **kw) -> "ProjectorSpec":
        return dataclasses.replace(self, **kw)

    # -- identity ----------------------------------------------------------- #
    def _identity(self) -> Tuple:
        """Content identity: geometry by canonical hash, the rest by value."""
        return (self.geom.canonical_hash(), self.model, self.backend,
                self.mode, self.compute_dtype, self.config)

    def __eq__(self, other):
        if not isinstance(other, ProjectorSpec):
            return NotImplemented
        return self._identity() == other._identity()

    def __hash__(self):
        return hash(self._identity())

    # -- keys --------------------------------------------------------------- #
    def cache_key(self, resolved_mode: Optional[str] = None,
                  in_dtype: Optional[str] = None) -> Tuple:
        """The op-cache key.  ``resolved_mode`` is the concrete pair
        dispatch picks ("exact" | "packed"), so that ``mode="auto"`` and an
        explicit equivalent share one bundle; ``in_dtype`` is the dtype name
        of the tensor the ops are applied to (a ``compute_dtype=None`` bundle
        follows its input's dtype, so f32 and bf16 callers get separate
        bundles)."""
        return (self.geom.canonical_hash(), self.model, self.backend,
                self.config, resolved_mode or self.mode, self.compute_dtype,
                in_dtype)

    def bucket_key(self) -> str:
        """Short stable digest: requests whose specs share this key can be
        packed into one batch (identical geometry content, kernels, mode
        policy and precision)."""
        cfg = (None if self.config is None
               else sorted(dataclasses.asdict(self.config).items()))
        payload = json.dumps(
            [self.geom.canonical_hash(), self.model, self.backend,
             self.mode, self.compute_dtype, cfg])
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def __repr__(self):
        g = self.geom
        extras = []
        if self.mode != "auto":
            extras.append(f"mode={self.mode}")
        if self.compute_dtype is not None:
            extras.append(f"compute_dtype={self.compute_dtype}")
        if self.config is not None:
            extras.append(f"config={self.config}")
        tail = (", " + ", ".join(extras)) if extras else ""
        return (f"ProjectorSpec({g.geom_type}, model={self.model}, "
                f"backend={self.backend}{tail}, vol={g.vol.shape}, "
                f"sino={g.sino_shape})")
