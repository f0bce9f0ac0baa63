"""Distributed CT projection on ``torch.distributed``, the counterpart of the
reference package's ``core/distributed.py``.

Two orthogonal sharding axes, matching the physics:

* **angle sharding**: the X-ray transform is a concatenation of independent
  per-view operators, so forward projection is embarrassingly parallel over
  views; the adjoint is a *sum* over views, an all-reduce over the angle
  group: one after the local backprojection, or one per comm block
  overlapped with the next block's kernels (``ShardSpec.comm``).
* **z-slab sharding**: axial slabs of the volume.  Three regimes:

  - *parallel / fan*: slabs are exactly independent (rays stay in
    z-planes), so the decomposition needs no communication and the halo
    must be 0.
  - *cone* (circular, source at z = 0): detector **row blocks** pair with
    volume slabs; a row block's rays diverge into the neighbour slab by at
    most the magnification overshoot, so each rank projects its slab
    extended by a ``halo`` of voxels exchanged with :func:`halo_exchange_z`.
  - *modular / helical* (**sliding-z pipeline**): the source travels in z,
    so contiguous **view bands** pair with volume slabs.  Each rank holds
    only its slab plus halo, so a long object that outgrows one device
    reconstructs end to end.

Every rank holds only its own pieces: the volume's z slab (replicated over
the angle axis) and its block of the sinogram (views over the angle axis
and rows over z; for sliding-z, views z-band-major over ``(z, angle)``).
:meth:`DistributedProjector.shard_volume` / ``shard_sino`` cut a global
tensor into this rank's piece and ``gather_volume`` / ``gather_sino``
assemble the global tensor from the pieces.

Matched pair: forward is the local A after the halo exchange; the
backprojector is the exact adjoint: the local Aᵀ, the all-reduce over the
angle group (the adjoint of the angle replication), then
:func:`halo_reduce_z` (the adjoint of the exchange).  The two are wired as
each other's backward through ``kernels/ops._make_pair``, double backward
included.  Each rank builds the op bundles of its own chunk geometry only.

The halo pair runs on ``all_gather`` within the z group, which gloo takes
on CUDA tensors too (its point-to-point ``send``/``recv`` take none), so
the same code runs on a gloo world of ranks sharing one card and on an
NCCL world of one rank per card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.geometry import CTGeometry
from repro_torch.core.spec import ProjectorSpec, ShardSpec, _warn_legacy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

__all__ = [
    "ShardSpec",
    "DistributedProjector",
    "distribute",
    "suggest_halo",
    "halo_exchange_z",
    "halo_reduce_z",
    "make_distributed_projector",
]


def _angle_chunks(geom: CTGeometry, n: int) -> List[CTGeometry]:
    if geom.n_angles % n != 0:
        raise ValueError(
            f"n_angles={geom.n_angles} must be divisible by the "
            f"{n} angle shards — pad or subset the scan to a multiple "
            f"(e.g. {geom.n_angles - geom.n_angles % n} views)")
    per = geom.n_angles // n
    return [geom.subset(np.arange(i * per, (i + 1) * per)) for i in range(n)]


# --------------------------------------------------------------------------- #
# z-halo collectives (matched pair: reduce is the exact adjoint of exchange)
# --------------------------------------------------------------------------- #
def _all_gather(t: torch.Tensor, mesh, axis: str) -> List[torch.Tensor]:
    """Every rank's ``t`` along ``axis``'s group, in coordinate order."""
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t.contiguous(), group=mesh.group(axis))
    return parts


def halo_exchange_z(f: torch.Tensor, mesh, axis: str, halo: int) -> torch.Tensor:
    """Exchange z-halos between neighbouring slab ranks.

    ``f``: (..., nx, ny, nz_local), this rank's slab.  Returns ``f``
    extended to ``nz_local + 2*halo`` with the neighbours' boundary slices
    (zeros at the fleet edges: the world outside the volume has no voxels).
    Its exact adjoint is :func:`halo_reduce_z`.  Every rank of the z group
    gathers every rank's two boundary blocks and keeps its neighbours'."""
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    if halo == 0:
        return f
    if halo >= f.shape[-1]:
        raise ValueError(
            f"halo={halo} must be smaller than the local slab depth "
            f"nz_local={f.shape[-1]} (a halo spanning a whole slab would "
            f"need second-neighbour exchange; use fewer z shards)")
    n, idx = mesh.shape[axis], mesh.coord(axis)
    lo, hi = f[..., :halo], f[..., -halo:]
    parts = _all_gather(torch.cat([lo, hi], dim=-1), mesh, axis)
    # the neighbour below's top, the neighbour above's bottom
    from_prev = parts[idx - 1][..., halo:] if idx > 0 else torch.zeros_like(hi)
    from_next = (parts[idx + 1][..., :halo] if idx < n - 1
                 else torch.zeros_like(lo))
    return torch.cat([from_prev, f, from_next], dim=-1)


def halo_reduce_z(g: torch.Tensor, mesh, axis: str, halo: int) -> torch.Tensor:
    """Exact adjoint of :func:`halo_exchange_z`.

    ``g``: (..., nx, ny, nz_local + 2*halo), a quantity accumulated on the
    halo-extended slab (a backprojection).  Adds each halo block onto the
    boundary of the neighbour that owns those voxels; fleet-edge halos are
    dropped (ghost voxels outside the volume).  Returns the owned
    (..., nx, ny, nz_local) core."""
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    if halo == 0:
        return g
    if 2 * halo >= g.shape[-1]:
        raise ValueError(
            f"halo={halo} inconsistent with extended slab depth "
            f"{g.shape[-1]} (needs nz_local = depth - 2*halo >= 1)")
    n, idx = mesh.shape[axis], mesh.coord(axis)
    lo, hi = g[..., :halo], g[..., -halo:]
    parts = _all_gather(torch.cat([lo, hi], dim=-1), mesh, axis)
    core = g[..., halo:-halo].clone()
    if idx < n - 1:                     # the neighbour above's lower halo
        core[..., -halo:] += parts[idx + 1][..., :halo]
    if idx > 0:                         # the neighbour below's upper halo
        core[..., :halo] += parts[idx - 1][..., halo:]
    return core


# --------------------------------------------------------------------------- #
# Halo sizing — conservative world-z extent of a view set's rays
# --------------------------------------------------------------------------- #
def _views_z_extent(geom: CTGeometry, view_idx: np.ndarray,
                    v_lo: float, v_hi: float) -> Tuple[float, float]:
    """Conservative world-z interval touched by the rays of ``view_idx``
    hitting detector rows in ``[v_lo, v_hi]`` (mm, row-coordinate edges).

    Bounds the ray–cylinder chord analytically: with source transaxial
    distance ``|s_xy|``, cylinder radius R, and per-ray transaxial reach
    ``|d_xy|``, the chord parameter lies in ``[(|s_xy|-R)/max|d_xy|,
    (|s_xy|+R)/min|d_xy|]``; z is bilinear in (t, d_z) so corner evaluation
    is exact.  One voxel of margin covers the SF footprint spread.
    """
    vol = geom.vol
    R = vol.radius + max(vol.dx, vol.dz)
    if geom.geom_type == "modular":
        src = np.asarray(geom.source_pos, np.float64)[view_idx]
        ctr = np.asarray(geom.det_center, np.float64)[view_idx]
        eu = np.asarray(geom.det_u, np.float64)[view_idx]
        ev = np.asarray(geom.det_v, np.float64)[view_idx]
    elif geom.geom_type == "cone":
        ang = np.asarray(geom.angles, np.float64)[view_idx]
        c, s = np.cos(ang), np.sin(ang)
        z0 = np.zeros_like(ang)
        src = np.stack([geom.sod * c, geom.sod * s, z0], -1)
        ctr = np.stack([(geom.sod - geom.sdd) * c,
                        (geom.sod - geom.sdd) * s, z0], -1)
        eu = np.stack([-s, c, z0], -1)
        ev = np.stack([z0, z0, np.ones_like(ang)], -1)
    else:
        raise ValueError(
            f"z extent bound only applies to cone/modular geometries, "
            f"got {geom.geom_type!r}")

    u = geom.u_coords()
    u0 = float(u[0]) - geom.pixel_width / 2.0
    u1 = float(u[-1]) + geom.pixel_width / 2.0
    v_abs = max(abs(v_lo), abs(v_hi))

    s_xy = np.hypot(src[:, 0], src[:, 1])
    C = ctr[:, :2] - src[:, :2]                     # transaxial source→center
    E = eu[:, :2]
    ev_xy = np.hypot(ev[:, 0], ev[:, 1])

    def _dxy(uv):
        d = C + uv * E
        return np.hypot(d[:, 0], d[:, 1])

    # |C + uE| over [u0, u1]: convex in u — max at the endpoints, min at the
    # clamped projection u* = -C·E/|E|².
    e2 = np.sum(E * E, axis=1)
    u_star = np.where(e2 > 1e-12, -np.sum(C * E, axis=1) / np.maximum(e2, 1e-12),
                      0.0)
    u_star = np.clip(u_star, u0, u1)
    d_star = np.hypot(C[:, 0] + u_star * E[:, 0], C[:, 1] + u_star * E[:, 1])
    dxy_min = np.minimum(d_star, np.minimum(_dxy(u0), _dxy(u1)))
    dxy_max = np.maximum(_dxy(u0), _dxy(u1))
    # A tilted row axis moves pixels transaxially by up to |v|·|ev_xy|.
    dxy_min = np.maximum(dxy_min - v_abs * ev_xy, 1e-6)
    dxy_max = dxy_max + v_abs * ev_xy

    t_lo = np.maximum(s_xy - R, 0.0) / dxy_max
    t_hi = (s_xy + R) / dxy_min

    # d_z over the (u, v) rectangle: linear, so corner evaluation is exact.
    base = ctr[:, 2] - src[:, 2]
    dz_terms = [base + uu * eu[:, 2] + vv * ev[:, 2]
                for uu in (u0, u1) for vv in (v_lo, v_hi)]
    dz_min = np.minimum.reduce(dz_terms)
    dz_max = np.maximum.reduce(dz_terms)

    cand = [t * d for t in (t_lo, t_hi) for d in (dz_min, dz_max)]
    z_min = np.min(src[:, 2] + np.minimum.reduce(cand)) - vol.dz
    z_max = np.max(src[:, 2] + np.maximum.reduce(cand)) + vol.dz
    return float(z_min), float(z_max)


def suggest_halo(geom: CTGeometry, z_shards: int) -> int:
    """Smallest safe z-halo (voxels) for slab-sharding ``geom`` over
    ``z_shards`` ranks: cone pairs detector row blocks with slabs,
    modular/helical pairs contiguous view bands with slabs (the sliding-z
    assignment).  Conservative — derived from the analytic ray-extent bound
    in :func:`_views_z_extent`, clamped to the volume.  Returns 0 for
    parallel/fan (exact slab independence) and for ``z_shards <= 1``.
    """
    if z_shards <= 1 or geom.geom_type in ("parallel", "fan"):
        return 0
    vol = geom.vol
    if vol.nz % z_shards != 0:
        raise ValueError(
            f"vol.nz={vol.nz} must be divisible by z_shards={z_shards}")
    nzl = vol.nz // z_shards
    zc = vol.z_coords()
    dz = vol.dz
    vol_lo, vol_hi = float(zc[0]) - dz / 2, float(zc[-1]) + dz / 2
    v = geom.v_coords()
    dv = geom.pixel_height
    need = 0
    for k in range(z_shards):
        if geom.geom_type == "cone":
            if geom.n_rows % z_shards != 0:
                raise ValueError(
                    f"n_rows={geom.n_rows} must be divisible by "
                    f"z_shards={z_shards} for cone row-block slabs")
            nvl = geom.n_rows // z_shards
            v_lo = float(v[k * nvl]) - dv / 2
            v_hi = float(v[(k + 1) * nvl - 1]) + dv / 2
            idx = np.arange(geom.n_angles)
        else:
            if geom.n_angles % z_shards != 0:
                raise ValueError(
                    f"n_angles={geom.n_angles} must be divisible by "
                    f"z_shards={z_shards} for sliding-z view bands")
            band = geom.n_angles // z_shards
            idx = np.arange(k * band, (k + 1) * band)
            v_lo = float(v[0]) - dv / 2
            v_hi = float(v[-1]) + dv / 2
        z_min, z_max = _views_z_extent(geom, idx, v_lo, v_hi)
        z_min, z_max = max(z_min, vol_lo), min(z_max, vol_hi)
        slab_lo = float(zc[k * nzl]) - dz / 2
        slab_hi = float(zc[(k + 1) * nzl - 1]) + dz / 2
        need = max(need,
                   int(math.ceil(max(slab_lo - z_min, 0.0) / dz)),
                   int(math.ceil(max(z_max - slab_hi, 0.0) / dz)))
    return need


# --------------------------------------------------------------------------- #
# Layout construction
# --------------------------------------------------------------------------- #
def _ext_slab_vol(vol, z_shards: int, k: int, halo: int):
    """The halo-extended slab sub-volume of shard ``k`` — same voxel grid as
    the corresponding world-z window of the global volume (frames and cone
    sources are world-space, so only the volume block changes)."""
    nzl = vol.nz // z_shards
    start = k * nzl - halo
    length = nzl + 2 * halo
    off = (start + (length - 1) / 2.0 - (vol.nz - 1) / 2.0) * vol.dz \
        + vol.offset_z
    return dataclasses.replace(vol, nz=length, offset_z=off)


def _row_block_geom(geom: CTGeometry, z_shards: int, k: int) -> CTGeometry:
    """Geometry restricted to detector row block ``k`` (cone z-slabs)."""
    nvl = geom.n_rows // z_shards
    cr = geom.center_row + geom.pixel_height * (
        k * nvl + (nvl - 1) / 2.0 - (geom.n_rows - 1) / 2.0)
    return dataclasses.replace(geom, n_rows=nvl, center_row=cr)


def _auto_comm_blocks(per: int) -> int:
    """Comm granularity for the overlap schedule: the most blocks (<= 4)
    that divide the per-shard view count.  (The reference also keeps each
    block a whole number of its TPU kernels' view blocks, ``bab``; the port's
    kernels have no such unit, and the reference's ``bab`` is 1 off the TPU,
    so the answers agree there.)"""
    for nb in (4, 3, 2):
        if per % nb == 0:
            return nb
    return 1


def _validate_mesh(shard: ShardSpec, mesh) -> None:
    for ax, n, what in ((shard.angle_axis, shard.angle_shards, "angle"),
                        (shard.z_axis, shard.z_shards, "z")):
        if ax is None:
            continue
        if ax not in mesh.shape:
            raise ValueError(
                f"mesh has no axis {ax!r} (axes: {tuple(mesh.axis_names)}); "
                f"fix ShardSpec.mesh_axes or the mesh")
        if int(mesh.shape[ax]) != n:
            raise ValueError(
                f"ShardSpec.{what}_shards={n} does not match mesh axis "
                f"{ax!r} of size {int(mesh.shape[ax])}")


@dataclasses.dataclass(frozen=True)
class _Layout:
    """One rank's part of a sharded operator: the local specs of its chunk
    geometry (the FP's, and the BP's per comm block) and how the pieces sit
    in the global tensors."""
    fp_spec: ProjectorSpec
    bp_specs: Tuple[ProjectorSpec, ...]
    blk: int                       # views per comm block
    use_halo: bool
    sliding_z: bool
    vol_local: Tuple[int, int, int]
    sino_local: Tuple[int, int, int]


def _validate_layout(spec: ProjectorSpec) -> None:
    """The reference's layout checks (``_build_distributed``), before any
    chunk geometry is built."""
    shard, geom = spec.shard, spec.geom
    nz, halo, gt, vol = shard.z_shards, shard.halo, geom.geom_type, geom.vol
    if nz <= 1:
        return
    if vol.nz % nz != 0:
        raise ValueError(
            f"vol.nz={vol.nz} must be divisible by z_shards={nz} "
            f"(pad the volume or change the mesh)")
    nzl = vol.nz // nz
    if gt in ("parallel", "fan"):
        if geom.n_rows % nz != 0:
            raise ValueError(
                f"n_rows={geom.n_rows} must be divisible by "
                f"z_shards={nz} for {gt} z-slabs")
        if halo != 0:
            raise ValueError(
                f"{gt} z-slabs are exactly independent (rays stay in "
                f"z-planes); halo must be 0, got {halo}")
    elif gt == "cone":
        if geom.n_rows % nz != 0:
            raise ValueError(
                f"n_rows={geom.n_rows} must be divisible by "
                f"z_shards={nz} (cone slabs pair with detector row "
                f"blocks)")
    if gt in ("cone", "modular"):
        need = suggest_halo(geom, nz)
        if need >= nzl:
            raise ValueError(
                f"{gt} z-slab sharding infeasible: the rays of a "
                f"shard's {'view band' if gt == 'modular' else 'row block'} "
                f"span {need} voxels beyond its slab, but the halo must "
                f"stay below nz_local={nzl}; use fewer z shards "
                f"(or angle sharding only)")
        if halo < need:
            raise ValueError(
                f"halo={halo} too small for this geometry: the widest "
                f"shard's rays reach {need} voxels into the neighbour "
                f"slab — pass halo>={need} (suggest_halo(geom, "
                f"z_shards) computes this)")
        if halo >= nzl:
            raise ValueError(
                f"halo={halo} must be < nz_local={nzl} "
                f"(single-neighbour exchange)")


def _build_layout(spec: ProjectorSpec, mesh) -> _Layout:
    """This rank's chunk of the sharded operator for ``spec`` on ``mesh``:
    its flat index ``iz * na + ia`` (sliding-z and cone slabs) or ``ia``
    picks the chunk the reference's ``lax.switch`` would."""
    shard, geom = spec.shard, spec.geom
    _validate_mesh(shard, mesh)
    _validate_layout(spec)
    na, nz, halo = shard.angle_shards, shard.z_shards, shard.halo
    gt, vol = geom.geom_type, geom.vol
    ia = mesh.coord(shard.angle_axis)
    iz = mesh.coord(shard.z_axis) if shard.z_axis is not None else 0
    sliding_z = gt == "modular" and nz > 1

    if sliding_z:
        if geom.n_angles % (na * nz) != 0:
            raise ValueError(
                f"n_angles={geom.n_angles} must be divisible by "
                f"angle_shards*z_shards={na * nz} for the sliding-z "
                f"pipeline (z bands × angle chunks)")
        per = geom.n_angles // (na * nz)
        band = geom.n_angles // nz
        g = geom.subset(np.arange(iz * band + ia * per,
                                  iz * band + (ia + 1) * per))
        g = dataclasses.replace(g, vol=_ext_slab_vol(vol, nz, iz, halo))
    else:
        chunk = _angle_chunks(geom, na)[ia]
        per = geom.n_angles // na
        if nz > 1 and gt == "cone":
            g = dataclasses.replace(_row_block_geom(chunk, nz, iz),
                                    vol=_ext_slab_vol(vol, nz, iz, halo))
        elif nz > 1:
            # parallel/fan: slabs are translation-invariant in z — one op
            # per angle chunk serves every slab shard.
            g = dataclasses.replace(chunk, vol=dataclasses.replace(
                vol, nz=vol.nz // nz), n_rows=geom.n_rows // nz)
        else:
            g = chunk

    if shard.comm == "psum":
        nb = max(1, shard.comm_blocks) if shard.comm_blocks else 1
    else:
        nb = shard.comm_blocks or _auto_comm_blocks(per)
    if per % nb != 0:
        raise ValueError(
            f"comm_blocks={nb} must divide the per-shard view count {per}")
    blk = per // nb
    fp_spec = spec.replace(geom=g, shard=None)
    if nb == 1:
        bp_specs = (fp_spec,)
    else:
        bp_specs = tuple(
            spec.replace(geom=g.subset(np.arange(b * blk, (b + 1) * blk)),
                         shard=None) for b in range(nb))
    nvl = geom.n_rows // nz if (nz > 1 and not sliding_z) else geom.n_rows
    return _Layout(fp_spec=fp_spec, bp_specs=bp_specs, blk=blk,
                   use_halo=halo > 0 and nz > 1, sliding_z=sliding_z,
                   vol_local=(vol.nx, vol.ny, vol.nz // nz),
                   sino_local=(per, nvl, geom.n_cols))


class _AllReduceSum(torch.autograd.Function):
    """Sum of every rank's ``t`` over ``groups`` in turn, on every rank.  Its
    backward is the identity: the sum is one global quantity held by every
    rank, so each rank's part of it moves with the sum's gradient there."""

    @staticmethod
    def forward(ctx, t, groups):
        out = t.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


# --------------------------------------------------------------------------- #
# Public objects
# --------------------------------------------------------------------------- #
class DistributedProjector:
    """A matched differentiable projector pair laid out on a mesh of ranks.

    Built from a :class:`ProjectorSpec` with a :class:`ShardSpec` attached,
    on every rank of the mesh::

        spec = ProjectorSpec(geom, shard=ShardSpec(("data", "model"),
                                                   angle_shards=2,
                                                   z_shards=2, halo=1))
        dp = DistributedProjector(spec, mesh)     # on "cuda" by default
        sino = dp(dp.shard_volume(f))             # this rank's piece of A x
        vol = dp.T(sino)                          # its piece of A^T y

    The object has the :class:`~repro_torch.core.projector.Projector`
    surface; ``sirt`` and ``cgls`` accept it and reduce their norms and
    inner products through :meth:`reduce_partial`, so every rank runs the
    same iteration on its own pieces.  ``vol_shape()`` / ``sino_shape()``
    are the global shapes, ``local_vol_shape()`` / ``local_sino_shape()``
    this rank's pieces'.  ``device=None`` means ``cuda`` and raises without
    it; ``device="cpu"`` runs the plain pairs on the host (a gloo world).
    """

    def __init__(self, spec: ProjectorSpec, mesh,
                 device: Optional[Union[str, torch.device]] = None):
        if not isinstance(spec, ProjectorSpec):
            raise TypeError(
                f"DistributedProjector needs a ProjectorSpec, got "
                f"{type(spec).__name__} (legacy geometry-first callers: "
                f"use make_distributed_projector or build a spec)")
        if spec.shard is None:
            raise ValueError(
                "spec has no ShardSpec attached; pass "
                "ProjectorSpec(geom, ..., shard=ShardSpec(...)) or use "
                "distribute(spec, mesh, ...)")
        self.spec = spec
        self.mesh = mesh
        self.device = resolve_device(device, "DistributedProjector")
        self._layout = _build_layout(spec, mesh)
        shard = spec.shard
        self._angle_group = mesh.group(shard.angle_axis)
        z = shard.z_axis
        self._vol_groups = () if z is None else (mesh.group(z),)
        self._sino_groups = (self._angle_group,) + self._vol_groups
        self.fp, self.bp = ops._make_pair(self._fp, self._bp)

    # -- the raw pair -------------------------------------------------------- #
    def _fp(self, x: torch.Tensor) -> torch.Tensor:
        lay, shard = self._layout, self.spec.shard
        if lay.use_halo:
            x = halo_exchange_z(x, self.mesh, shard.z_axis, shard.halo)
        return ops.forward_project(x, lay.fp_spec)

    def _bp(self, p: torch.Tensor) -> torch.Tensor:
        """Per comm block: the local BP, then an asynchronous all-reduce over
        the angle group, so block b's reduction overlaps block b+1's
        kernels; the sum over blocks waits on each; then the halo-reduce."""
        lay, shard = self._layout, self.spec.shard
        nb, blk = len(lay.bp_specs), lay.blk
        parts, works = [], []
        for b, bspec in enumerate(lay.bp_specs):
            pb = p if nb == 1 else p[..., b * blk:(b + 1) * blk, :, :].contiguous()
            part = ops.back_project(pb, bspec)
            works.append(dist.all_reduce(part, group=self._angle_group,
                                         async_op=True))
            parts.append(part)
        acc = None
        for part, work in zip(parts, works):
            work.wait()
            acc = part if acc is None else acc + part
        if lay.use_halo:
            acc = halo_reduce_z(acc, self.mesh, shard.z_axis, shard.halo)
        return acc

    # -- Projector-compatible surface -------------------------------------- #
    @property
    def geom(self) -> CTGeometry:
        return self.spec.geom

    @property
    def shard(self) -> ShardSpec:
        return self.spec.shard

    def _on_device(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != self.device.type:
            raise ValueError(
                f"this DistributedProjector runs on {self.device}, but got a "
                f"tensor on {x.device}; move it with "
                f".to({str(self.device)!r})")
        return x

    def __call__(self, volume: torch.Tensor) -> torch.Tensor:
        return self.fp(self._on_device(volume))

    forward = __call__

    def backproject(self, sino: torch.Tensor) -> torch.Tensor:
        return self.bp(self._on_device(sino))

    @property
    def T(self):
        return self.backproject

    def vol_shape(self):
        return self.geom.vol.shape

    def sino_shape(self):
        return self.geom.sino_shape

    def local_vol_shape(self):
        return self._layout.vol_local

    def local_sino_shape(self):
        return self._layout.sino_local

    def reduce_partial(self, t: torch.Tensor, space: str) -> torch.Tensor:
        """Sum of every rank's partial sum ``t`` over the pieces of the global
        sinogram (``space="sino"``: the angle and z groups) or volume
        (``"vol"``: the z group; the volume is replicated over the angle
        axis, which a wider sum would count ``angle_shards`` times).
        Differentiable (identity backward)."""
        if space not in ("sino", "vol"):
            raise ValueError(f"space must be 'sino' or 'vol', got {space!r}")
        groups = self._sino_groups if space == "sino" else self._vol_groups
        return _AllReduceSum.apply(t, groups)

    def data_consistency(self, volume, measured, mask=None) -> torch.Tensor:
        """0.5 * || M (A x - y) ||^2 / n over the global sinogram, from this
        rank's pieces of ``volume`` and ``measured``; the same value on
        every rank."""
        r = self(volume) - measured
        if mask is not None:
            r = r * mask
        local = math.prod(self.local_sino_shape())
        n = (r.numel() // local) * math.prod(self.sino_shape())
        return 0.5 * self.reduce_partial(torch.sum(torch.square(r)), "sino") / n

    # -- placement helpers -------------------------------------------------- #
    def shard_volume(self, f: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a global (..., nx, ny, nz) volume: its z slab
        (replicated over the angle axis), on the projector's device."""
        nzl = self._layout.vol_local[2]
        iz = self._z_coord()
        return f[..., iz * nzl:(iz + 1) * nzl].contiguous().to(self.device)

    def shard_sino(self, p: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a global (..., n_angles, n_rows, n_cols)
        sinogram: its views (z-band-major over ``(z, angle)`` for the
        sliding-z pipeline) and, for z-slabs, its rows."""
        per, nvl, _ = self._layout.sino_local
        shard = self.spec.shard
        ia, iz = self.mesh.coord(shard.angle_axis), self._z_coord()
        if self._layout.sliding_z:
            flat = iz * shard.angle_shards + ia
            piece = p[..., flat * per:(flat + 1) * per, :, :]
        else:
            piece = p[..., ia * per:(ia + 1) * per, iz * nvl:(iz + 1) * nvl, :]
        return piece.contiguous().to(self.device)

    def _z_coord(self) -> int:
        z = self.spec.shard.z_axis
        return 0 if z is None else self.mesh.coord(z)

    def _gather(self, t: torch.Tensor, axis: Optional[str], dim: int):
        if axis is None or self.mesh.shape[axis] == 1:
            return t
        return torch.cat(_all_gather(t, self.mesh, axis), dim=dim)

    def gather_volume(self, v: torch.Tensor) -> torch.Tensor:
        """The global volume from every rank's slab (on every rank)."""
        return self._gather(v, self.spec.shard.z_axis, -1)

    def gather_sino(self, p: torch.Tensor) -> torch.Tensor:
        """The global sinogram from every rank's piece (on every rank)."""
        shard = self.spec.shard
        if self._layout.sliding_z:
            p = self._gather(p, shard.angle_axis, -3)
            return self._gather(p, shard.z_axis, -3)
        p = self._gather(p, shard.z_axis, -2)
        return self._gather(p, shard.angle_axis, -3)

    def __repr__(self):
        s = self.shard
        return (f"DistributedProjector({self.geom.geom_type}, "
                f"angle_shards={s.angle_shards}, z_shards={s.z_shards}, "
                f"halo={s.halo}, comm={s.comm}, device={self.device}, "
                f"vol={self.geom.vol.shape}, sino={self.geom.sino_shape})")


def distribute(spec: ProjectorSpec, mesh, *, angle_axis: str = "data",
               z_axis: Optional[str] = None, halo: Optional[int] = None,
               comm: str = "psum", comm_blocks: int = 0,
               device: Optional[Union[str, torch.device]] = None
               ) -> DistributedProjector:
    """Attach a mesh-derived :class:`ShardSpec` to ``spec`` and build the
    :class:`DistributedProjector`.

    ``halo=None`` sizes the z-halo with :func:`suggest_halo` (0 for
    parallel/fan).  A spec that already carries a shard passes through
    unchanged (mixing it with layout kwargs raises).
    """
    if not isinstance(spec, ProjectorSpec):
        raise TypeError(
            f"distribute() needs a ProjectorSpec, got "
            f"{type(spec).__name__}")
    if spec.shard is not None:
        if (angle_axis, z_axis, halo, comm, comm_blocks) != \
                ("data", None, None, "psum", 0):
            raise TypeError(
                "distribute(): pass either a spec with a ShardSpec or "
                "layout kwargs, not both")
        return DistributedProjector(spec, mesh, device)
    z_shards = int(mesh.shape[z_axis]) if z_axis else 1
    if halo is None:
        halo = suggest_halo(spec.geom, z_shards)
    shard = ShardSpec(mesh_axes=(angle_axis, z_axis),
                      angle_shards=int(mesh.shape[angle_axis]),
                      z_shards=z_shards, halo=halo, comm=comm,
                      comm_blocks=comm_blocks)
    return DistributedProjector(spec.replace(shard=shard), mesh, device)


# --------------------------------------------------------------------------- #
# Legacy-call-site shim (pre-ShardSpec 4-tuple factory)
# --------------------------------------------------------------------------- #
def make_distributed_projector(geom: CTGeometry, mesh, model: str = "sf",
                               backend: str = "auto",
                               angle_axis: str = "data",
                               z_axis: Optional[str] = None,
                               mode: str = "auto",
                               device: Optional[Union[str, torch.device]] = None):
    """Deprecated 4-tuple factory — returns ``(fp, bp, shard_volume,
    shard_sino)`` with the synchronous single all-reduce schedule.  Build a
    ``ProjectorSpec`` with a ``ShardSpec`` and use
    :class:`DistributedProjector` instead; warns once per process.
    """
    _warn_legacy("make_distributed_projector")
    if z_axis and geom.geom_type not in ("parallel", "fan"):
        raise NotImplementedError(
            "z-slab sharding requires parallel or fan beam (exact z "
            "independence) through this legacy factory; cone/modular "
            "z-slabs need a halo — use DistributedProjector with "
            "ShardSpec(halo=suggest_halo(geom, z_shards))")
    shard = ShardSpec(mesh_axes=(angle_axis, z_axis),
                      angle_shards=int(mesh.shape[angle_axis]),
                      z_shards=int(mesh.shape[z_axis]) if z_axis else 1,
                      halo=0, comm="psum", comm_blocks=1)
    spec = ProjectorSpec(geom, model=model, backend=backend, mode=mode,
                         shard=shard)
    dp = DistributedProjector(spec, mesh, device)
    return dp.fp, dp.bp, dp.shard_volume, dp.shard_sino
