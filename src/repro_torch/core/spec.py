"""``ProjectorSpec`` — the single immutable description of a projection op.

    >>> spec = ProjectorSpec(geom, model="sf", compute_dtype="bf16")
    >>> proj = Projector(spec)
    >>> sino = forward_project(f, spec)

The spec is the op-cache key (``spec.cache_key()``), the admission-bucket
key for batching compatible requests (``spec.bucket_key()``), and the
validation point: bad model/backend/dtype values raise here, once.  A
:class:`ShardSpec` attached as ``shard`` lays the operator out over a
``torch.distributed`` mesh; such a spec is realized by
``repro_torch.core.distributed.DistributedProjector``, never by the local op
cache.  :func:`as_spec` coerces a geometry-first call to a spec, warning
once per entry point.

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
import warnings
from typing import Optional, Tuple, TYPE_CHECKING

from repro_torch.core.geometry import CTGeometry

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.kernels.tune import KernelConfig

__all__ = ["ProjectorSpec", "ShardSpec", "as_spec", "reset_legacy_warnings"]

_MODELS = ("sf", "joseph")
_BACKENDS = ("auto", "cuda", "ref")
_MODES = ("auto", "exact", "packed")
_COMMS = ("overlap", "psum")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Frozen description of how a projection operator is laid out on a mesh.

    The layout is part of the operator's identity: two distributed
    projectors with different layouts run different collectives and must
    not share op-cache entries or serving buckets, so ``ShardSpec`` takes
    part in ``ProjectorSpec.cache_key()`` / ``bucket_key()``.

    Fields:
        mesh_axes:     ``(angle_axis, z_axis)`` mesh-axis names.  ``z_axis``
                       may be ``None`` when ``z_shards == 1`` (pure angle
                       sharding).
        angle_shards:  shards along the views (independent in the forward
                       direction, summed in the adjoint).
        z_shards:      shards along the volume's z axis (axial slabs).
        halo:          z-slab halo width in voxels exchanged between
                       neighbouring slabs.  Must be 0 for parallel/fan
                       (their slabs are exactly independent) and large
                       enough for cone/modular z-slabs (diverging or
                       z-travelling rays read into the neighbour slab).
        comm:          backprojection reduction schedule: ``"psum"``
                       (default) is one all-reduce after all local views
                       are backprojected; ``"overlap"`` splits the local
                       views into comm blocks and issues one asynchronous
                       all-reduce per block, so block *b*'s reduction
                       overlaps block *b+1*'s backprojection.  Each block
                       reduces a whole slab, so ``"overlap"`` moves
                       ``comm_blocks`` times the bytes; on ranks that share
                       one card over gloo it was slower than one
                       all-reduce on every cell measured (PERF.md), so the
                       default differs from the reference's until a run of
                       one rank a card shows it paying.
        comm_blocks:   number of comm blocks for ``comm="overlap"``; 0 means
                       auto (the most blocks, at most 4, that divide the
                       per-shard view count).
    """

    mesh_axes: Tuple[Optional[str], ...] = ("data", "model")
    angle_shards: int = 1
    z_shards: int = 1
    halo: int = 0
    comm: str = "psum"
    comm_blocks: int = 0

    def __post_init__(self):
        axes = tuple(self.mesh_axes)
        if len(axes) != 2:
            raise ValueError(
                f"mesh_axes must be (angle_axis, z_axis), got {axes!r}")
        if not isinstance(axes[0], str) or not axes[0]:
            raise ValueError(
                f"angle axis (mesh_axes[0]) must be a mesh-axis name, "
                f"got {axes[0]!r}")
        if axes[1] is not None and (not isinstance(axes[1], str)
                                    or axes[1] == axes[0]):
            raise ValueError(
                f"z axis (mesh_axes[1]) must be None or a mesh-axis name "
                f"distinct from the angle axis, got {axes!r}")
        object.__setattr__(self, "mesh_axes", axes)
        if self.angle_shards < 1 or self.z_shards < 1:
            raise ValueError(
                f"angle_shards/z_shards must be >= 1, got "
                f"{(self.angle_shards, self.z_shards)}")
        if self.z_shards > 1 and axes[1] is None:
            raise ValueError(
                f"z_shards={self.z_shards} needs a z mesh axis "
                f"(mesh_axes[1] is None)")
        if self.halo < 0:
            raise ValueError(f"halo must be >= 0, got {self.halo}")
        if self.z_shards == 1 and self.halo != 0:
            raise ValueError(
                f"halo={self.halo} is meaningless with z_shards=1; "
                f"set halo=0")
        if self.comm not in _COMMS:
            raise ValueError(f"unknown comm schedule {self.comm!r}; "
                             f"expected one of {_COMMS}")
        if self.comm_blocks < 0:
            raise ValueError(
                f"comm_blocks must be >= 0 (0 = auto), got {self.comm_blocks}")

    @property
    def angle_axis(self) -> str:
        return self.mesh_axes[0]

    @property
    def z_axis(self) -> Optional[str]:
        return self.mesh_axes[1]

    def replace(self, **kw) -> "ShardSpec":
        return dataclasses.replace(self, **kw)

    def _identity(self) -> Tuple:
        return (self.mesh_axes, self.angle_shards, self.z_shards, self.halo,
                self.comm, self.comm_blocks)


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
        shard:         :class:`ShardSpec` describing a multi-rank layout, or
                       None for a single-device operator.  A spec with a
                       shard is realized through
                       :class:`repro_torch.core.distributed.DistributedProjector`;
                       the local op cache refuses it.
    """

    geom: CTGeometry
    model: str = "sf"
    backend: str = "auto"
    mode: str = "auto"
    compute_dtype: Optional[str] = None
    config: Optional["KernelConfig"] = None
    shard: Optional[ShardSpec] = None

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
        if self.shard is not None and not isinstance(self.shard, ShardSpec):
            raise TypeError(f"shard must be a ShardSpec, got {self.shard!r}")
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
    def _shard_key(self) -> Tuple:
        """The shard's identity as a key suffix: empty without a shard, so
        a single-device spec keeps the keys it had before shards existed."""
        return () if self.shard is None else (self.shard._identity(),)

    def _identity(self) -> Tuple:
        """Content identity: geometry by canonical hash, the rest by value."""
        return (self.geom.canonical_hash(), self.model, self.backend,
                self.mode, self.compute_dtype, self.config) + self._shard_key()

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
                in_dtype) + self._shard_key()

    def bucket_key(self) -> str:
        """Short stable digest: requests whose specs share this key can be
        packed into one batch (identical geometry content, kernels, mode
        policy, precision and shard layout).  With a shard it is the
        reference package's digest of the same spec."""
        cfg = (None if self.config is None
               else sorted(dataclasses.asdict(self.config).items()))
        if self.shard is None:
            payload = json.dumps(
                [self.geom.canonical_hash(), self.model, self.backend,
                 self.mode, self.compute_dtype, cfg])
        else:
            shard = sorted(dataclasses.asdict(self.shard).items(),
                           key=lambda kv: kv[0])
            payload = json.dumps(
                [self.geom.canonical_hash(), self.model, self.backend,
                 self.mode, self.compute_dtype, cfg, shard])
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
        if self.shard is not None:
            extras.append(f"shard={self.shard}")
        tail = (", " + ", ".join(extras)) if extras else ""
        return (f"ProjectorSpec({g.geom_type}, model={self.model}, "
                f"backend={self.backend}{tail}, vol={g.vol.shape}, "
                f"sino={g.sino_shape})")


# --------------------------------------------------------------------------- #
# Legacy-call-site shim
# --------------------------------------------------------------------------- #
_DEFAULTS = ("sf", "auto", "auto", None, None)
_WARNED: set = set()


def _warn_legacy(api: str) -> None:
    if api in _WARNED:
        return
    _WARNED.add(api)
    warnings.warn(
        f"{api} with geometry-first arguments is deprecated; build a "
        f"ProjectorSpec once and pass it instead, e.g. "
        f"spec = ProjectorSpec(geom, model=..., backend=...); {api}(spec). "
        f"(warned once per process)",
        DeprecationWarning, stacklevel=4)


def reset_legacy_warnings() -> None:
    """Forget which entry points already warned (test hook)."""
    _WARNED.clear()


def as_spec(spec_or_geom, api: str, model: str = "sf", backend: str = "auto",
            mode: str = "auto", compute_dtype=None,
            config=None) -> ProjectorSpec:
    """Coerce an entry point's first argument to a :class:`ProjectorSpec`.

    A spec passes through unchanged (mixing it with legacy keyword arguments
    is ambiguous and raises); a :class:`CTGeometry` takes the legacy path:
    one :class:`DeprecationWarning` per ``api`` per process, then the
    equivalent spec."""
    if isinstance(spec_or_geom, ProjectorSpec):
        if (model, backend, mode, compute_dtype, config) != _DEFAULTS:
            raise TypeError(
                f"{api}: pass either a ProjectorSpec or legacy keyword "
                f"arguments, not both (got spec plus non-default kwargs)")
        return spec_or_geom
    if isinstance(spec_or_geom, CTGeometry):
        _warn_legacy(api)
        return ProjectorSpec(spec_or_geom, model=model, backend=backend,
                             mode=mode, compute_dtype=compute_dtype,
                             config=config)
    raise TypeError(f"{api}: expected a ProjectorSpec or CTGeometry, "
                    f"got {type(spec_or_geom).__name__}")
