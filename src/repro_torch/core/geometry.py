"""CT scanner geometry and reconstruction-volume specifications.

Conventions (all quantities in mm; reconstructed values in 1/mm — the paper's
"quantitatively accurate" requirement):

Volume
    ``f[ix, iy, iz]`` with shape ``(nx, ny, nz)``.  World coordinates::

        x(ix) = (ix - (nx-1)/2) * dx + offset_x          (same for y, z)

    ``z`` is the rotation axis.  ``z`` is deliberately the *last* axis so the
    kernels can put it on the contiguous lane axis (axial geometries are
    embarrassingly vectorizable over z).

Projections (sinogram)
    ``p[ia, iv, iu]`` with shape ``(n_angles, n_rows, n_cols)``; ``v`` indexes
    detector rows (parallel to z), ``u`` detector columns::

        u(iu) = (iu - (nu-1)/2) * du + center_col_mm
        v(iv) = (iv - (nv-1)/2) * dv + center_row_mm

Geometry types (the paper's geometry classes):
    * ``parallel``  — rays along (cos phi, sin phi, 0); detector u-axis is
      (-sin phi, cos phi, 0), v-axis is +z.
    * ``fan``       — 2D divergent beam: point source at radius ``sod`` in the
      transaxial plane, detector at distance ``sdd`` from the source.  Each
      detector row is an independent in-plane fan of the matching z-slab
      (the axial footprint is the parallel-beam rectangle overlap — no axial
      magnification).  ``detector_type="flat"`` means equispaced columns in
      mm on a flat detector; ``"curved"`` means an equiangular arc centered
      on the source, with ``u`` the arc length (mm), i.e. the fan angle is
      ``gamma = u / sdd``.
    * ``cone``      — point source at radius ``sod`` from the rotation axis,
      flat or curved detector at distance ``sdd`` from the source.
      Source position: ``s(phi) = (sod cos phi, sod sin phi, 0)``;
      detector center: ``s - sdd*(cos phi, sin phi, 0)`` (+ shifts).
    * ``modular``   — arbitrary per-view source position / detector center /
      detector (u, v) axes.

The dataclasses are frozen and contain only Python scalars / tuples /
numpy arrays so a geometry instance is *static metadata*: its content hash
is the op-cache key, and the per-view kernel tables are derived from it
once per cached op bundle.

This module is numpy-only and kept identical in content to the reference
package's geometry module, so configs and hashes agree across the two.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "VolumeGeometry",
    "CTGeometry",
    "parallel_beam",
    "fan_beam",
    "cone_beam",
    "modular_beam",
    "helical_beam",
    "from_config",
]


def _as_f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _canon_value(v):
    """Canonicalize one geometry field for the stable content key.

    Floats round through float32 (what every kernel consumes) so python
    floats and numpy scalars of the same value serialize identically; arrays
    are replaced by a content digest of their canonical float32 bytes."""
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v, dtype=np.float32)
        return ["ndarray", list(a.shape),
                hashlib.sha256(a.tobytes()).hexdigest()]
    if isinstance(v, (bool, str)) or v is None:
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(np.float32(v))
    if isinstance(v, (tuple, list)):
        return [_canon_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _canon_value(x) for k, x in sorted(v.items())}
    return str(v)


@dataclasses.dataclass(frozen=True)
class VolumeGeometry:
    """Reconstruction volume: ``(nx, ny, nz)`` voxels of size ``(dx, dy, dz)`` mm."""

    nx: int
    ny: int
    nz: int
    dx: float = 1.0
    dy: float = 1.0
    dz: float = 1.0
    offset_x: float = 0.0
    offset_y: float = 0.0
    offset_z: float = 0.0

    def __post_init__(self):
        if self.nx <= 0 or self.ny <= 0 or self.nz <= 0:
            raise ValueError(f"volume dims must be positive, got {(self.nx, self.ny, self.nz)}")
        if self.dx <= 0 or self.dy <= 0 or self.dz <= 0:
            raise ValueError("voxel sizes must be positive")
        if not math.isclose(self.dx, self.dy, rel_tol=1e-6):
            # The SF transaxial footprint assumes square in-plane voxels
            # (same restriction as LEAP).
            raise ValueError("in-plane voxels must be square (dx == dy)")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    def x_coords(self) -> np.ndarray:
        return _as_f32((np.arange(self.nx) - (self.nx - 1) / 2.0) * self.dx + self.offset_x)

    def y_coords(self) -> np.ndarray:
        return _as_f32((np.arange(self.ny) - (self.ny - 1) / 2.0) * self.dy + self.offset_y)

    def z_coords(self) -> np.ndarray:
        return _as_f32((np.arange(self.nz) - (self.nz - 1) / 2.0) * self.dz + self.offset_z)

    @property
    def radius(self) -> float:
        """Circumscribing transaxial radius of the volume (mm)."""
        rx = self.nx * self.dx / 2.0 + abs(self.offset_x)
        ry = self.ny * self.dy / 2.0 + abs(self.offset_y)
        return math.hypot(rx, ry)

    def scale(self, s: float) -> "VolumeGeometry":
        return dataclasses.replace(
            self, dx=self.dx * s, dy=self.dy * s, dz=self.dz * s,
            offset_x=self.offset_x * s, offset_y=self.offset_y * s,
            offset_z=self.offset_z * s)


@dataclasses.dataclass(frozen=True)
class CTGeometry:
    """Full scanner description: projections layout + beam geometry + volume."""

    geom_type: str                      # "parallel" | "fan" | "cone" | "modular"
    vol: VolumeGeometry
    n_angles: int
    n_rows: int                         # detector rows (v / axial)
    n_cols: int                         # detector columns (u / transaxial)
    pixel_height: float = 1.0           # dv, mm
    pixel_width: float = 1.0            # du, mm
    # Either an angular range (equispaced) or an explicit tuple of angles (rad).
    angles: Tuple[float, ...] = ()
    sod: float = 0.0                    # source-to-object distance (cone)
    sdd: float = 0.0                    # source-to-detector distance (cone)
    center_row: float = 0.0             # vertical detector shift, mm
    center_col: float = 0.0             # horizontal detector shift, mm
    detector_type: str = "flat"         # "flat" | "curved"  (cone only)
    # Modular geometry: per-view 3-vectors, shape (n_angles, 3).
    source_pos: Optional[np.ndarray] = None
    det_center: Optional[np.ndarray] = None
    det_u: Optional[np.ndarray] = None  # unit vector along columns
    det_v: Optional[np.ndarray] = None  # unit vector along rows

    def __post_init__(self):
        if self.geom_type not in ("parallel", "fan", "cone", "modular"):
            raise ValueError(f"unknown geometry type {self.geom_type!r}")
        if self.n_angles <= 0 or self.n_rows <= 0 or self.n_cols <= 0:
            raise ValueError("projection dims must be positive")
        if self.pixel_width <= 0 or self.pixel_height <= 0:
            raise ValueError("pixel sizes must be positive")
        if len(self.angles) != self.n_angles and self.geom_type != "modular":
            raise ValueError(
                f"angles has {len(self.angles)} entries, expected n_angles={self.n_angles}")
        if self.geom_type in ("fan", "cone"):
            if not (self.sdd > self.sod > 0):
                raise ValueError(
                    f"{self.geom_type} beam requires sdd > sod > 0")
            if self.detector_type not in ("flat", "curved"):
                raise ValueError(f"unknown detector type {self.detector_type!r}")
            if self.sod <= self.vol.radius:
                raise ValueError(
                    f"source (sod={self.sod}) inside volume radius {self.vol.radius:.2f}")
        if self.geom_type == "fan" and self.detector_type == "curved":
            # arc length must stay inside the half circle around the source
            umax = (self.n_cols - 1) / 2.0 * self.pixel_width + abs(self.center_col)
            if umax / self.sdd >= math.pi / 2:
                raise ValueError(
                    "curved fan detector spans a fan angle >= pi/2; widen sdd "
                    "or shrink the detector")
        if self.geom_type == "modular":
            for name in ("source_pos", "det_center", "det_u", "det_v"):
                v = getattr(self, name)
                if v is None or np.asarray(v).shape != (self.n_angles, 3):
                    raise ValueError(f"modular geometry needs {name} with shape (n_angles, 3)")

    # ------------------------------------------------------------------ #
    @property
    def sino_shape(self) -> Tuple[int, int, int]:
        return (self.n_angles, self.n_rows, self.n_cols)

    def angles_array(self) -> np.ndarray:
        return _as_f32(self.angles)

    def u_coords(self) -> np.ndarray:
        return _as_f32((np.arange(self.n_cols) - (self.n_cols - 1) / 2.0)
                       * self.pixel_width + self.center_col)

    def v_coords(self) -> np.ndarray:
        return _as_f32((np.arange(self.n_rows) - (self.n_rows - 1) / 2.0)
                       * self.pixel_height + self.center_row)

    @property
    def magnification(self) -> float:
        return self.sdd / self.sod if self.geom_type in ("fan", "cone") else 1.0

    def max_footprint_cols(self) -> int:
        """Static bound on how many detector columns one voxel can cover (SF)."""
        mag = 1.0
        if self.geom_type in ("fan", "cone"):
            # A curved (equiangular) fan footprint in arc length is never wider
            # than the flat-detector one at the same sdd, so the flat bound
            # covers both detector types.
            mag = self.sdd / max(self.sod - self.vol.radius, 1e-3)
        width = math.sqrt(2.0) * self.vol.dx * mag
        return int(math.ceil(width / self.pixel_width)) + 2

    def max_footprint_rows(self) -> int:
        """Static bound on detector rows covered by one voxel (SF, axial).
        Fan beams are in-plane: rows see the parallel-beam (unmagnified)
        rectangle overlap."""
        mag = 1.0
        if self.geom_type == "cone":
            mag = self.sdd / max(self.sod - self.vol.radius, 1e-3)
        return int(math.ceil(self.vol.dz * mag / self.pixel_height)) + 2

    def with_angles(self, angles) -> "CTGeometry":
        angles = tuple(float(a) for a in np.asarray(angles).ravel())
        return dataclasses.replace(self, angles=angles, n_angles=len(angles))

    def subset(self, idx) -> "CTGeometry":
        """Geometry restricted to a subset of views (few-view / limited-angle)."""
        idx = np.asarray(idx)
        kw = {}
        if self.geom_type == "modular":
            for name in ("source_pos", "det_center", "det_u", "det_v"):
                kw[name] = np.asarray(getattr(self, name))[idx]
            return dataclasses.replace(self, n_angles=len(idx), angles=(0.0,) * 0, **kw)
        ang = tuple(np.asarray(self.angles)[idx].tolist())
        return dataclasses.replace(self, angles=ang, n_angles=len(idx))

    # Hashable / usable as a static jit argument.
    def key(self) -> str:
        """Canonical content serialization — stable across construction paths.

        Two geometries describing the same scanner must produce the *same*
        string no matter how they were built (constructor call, ``from_config``
        round-trip, numpy vs python scalars): this key is the op-cache key and
        the serving admission-bucket key, so an unstable serialization would
        silently duplicate compiled kernels and split server batches.

        Stability rules:
          * every scalar float is canonicalized through float32 (the dtype
            all kernels consume) before serialization, so ``sod=200.0`` and
            ``sod=np.float32(200)`` collide — previously numpy scalars fell
            into ``json.dumps(default=str)`` and produced a *different* key
            than an equal python float;
          * per-view modular frame arrays are hashed by *content* (sha256 of
            their canonical float32 bytes), never by repr — identical frames
            always share a key, and the key stays short for 1000-view scans.
        """
        cached = getattr(self, "_key_cache", None)
        if cached is not None:
            return cached
        d = dataclasses.asdict(self)
        canon = {k: _canon_value(v) for k, v in sorted(d.items())}
        out = json.dumps(canon, sort_keys=True)
        object.__setattr__(self, "_key_cache", out)
        return out

    def canonical_hash(self) -> str:
        """Short content digest of :meth:`key` — equal geometries (up to the
        float32 precision the kernels run at) share this hash.  This is the
        serving layer's admission-bucket key and part of
        ``ProjectorSpec.cache_key()``."""
        cached = getattr(self, "_hash_cache", None)
        if cached is not None:
            return cached
        h = hashlib.sha256(self.key().encode()).hexdigest()[:16]
        object.__setattr__(self, "_hash_cache", h)
        return h

    def to_config(self) -> dict:
        """Plain JSON-serializable dict accepted by :func:`from_config`.

        Round-trip contract (the serving layer relies on it):
        ``from_config(g.to_config()).canonical_hash() == g.canonical_hash()``.
        """
        vol = dataclasses.asdict(self.vol)
        if self.geom_type == "modular":
            return {
                "geom_type": "modular", "volume": vol,
                "n_rows": self.n_rows, "n_cols": self.n_cols,
                "pixel_width": self.pixel_width,
                "pixel_height": self.pixel_height,
                "source_pos": np.asarray(self.source_pos).tolist(),
                "det_center": np.asarray(self.det_center).tolist(),
                "det_u": np.asarray(self.det_u).tolist(),
                "det_v": np.asarray(self.det_v).tolist(),
            }
        cfg = {
            "geom_type": self.geom_type, "volume": vol,
            "n_angles": self.n_angles, "n_rows": self.n_rows,
            "n_cols": self.n_cols,
            "pixel_width": self.pixel_width,
            "pixel_height": self.pixel_height,
            "angles": list(self.angles),
            "center_row": self.center_row, "center_col": self.center_col,
        }
        if self.geom_type in ("fan", "cone"):
            cfg.update(sod=self.sod, sdd=self.sdd,
                       detector_type=self.detector_type)
        return cfg


# ---------------------------------------------------------------------- #
# Constructors
# ---------------------------------------------------------------------- #
def _equi_angles(n: int, arange_deg: float, start_deg: float = 0.0) -> Tuple[float, ...]:
    a = start_deg + np.arange(n) * (arange_deg / n)
    return tuple(np.deg2rad(a).tolist())


def parallel_beam(n_angles: int, n_rows: int, n_cols: int, vol: VolumeGeometry,
                  pixel_width: float = 1.0, pixel_height: float = 1.0,
                  angular_range: float = 180.0, angles=None,
                  center_row: float = 0.0, center_col: float = 0.0) -> CTGeometry:
    ang = (tuple(float(x) for x in np.asarray(angles).ravel()) if angles is not None
           else _equi_angles(n_angles, angular_range))
    return CTGeometry("parallel", vol, n_angles, n_rows, n_cols,
                      pixel_height, pixel_width, ang,
                      center_row=center_row, center_col=center_col)


def fan_beam(n_angles: int, n_rows: int, n_cols: int, vol: VolumeGeometry,
             sod: float, sdd: float,
             pixel_width: float = 1.0, pixel_height: float = 1.0,
             angular_range: float = 360.0, angles=None,
             center_row: float = 0.0, center_col: float = 0.0,
             detector_type: str = "flat") -> CTGeometry:
    """Fan-beam scanner: ``detector_type="flat"`` gives equispaced columns,
    ``"curved"`` an equiangular arc (``u`` = arc length, fan angle u/sdd)."""
    ang = (tuple(float(x) for x in np.asarray(angles).ravel()) if angles is not None
           else _equi_angles(n_angles, angular_range))
    return CTGeometry("fan", vol, n_angles, n_rows, n_cols,
                      pixel_height, pixel_width, ang, sod=sod, sdd=sdd,
                      center_row=center_row, center_col=center_col,
                      detector_type=detector_type)


def cone_beam(n_angles: int, n_rows: int, n_cols: int, vol: VolumeGeometry,
              sod: float, sdd: float,
              pixel_width: float = 1.0, pixel_height: float = 1.0,
              angular_range: float = 360.0, angles=None,
              center_row: float = 0.0, center_col: float = 0.0,
              detector_type: str = "flat") -> CTGeometry:
    ang = (tuple(float(x) for x in np.asarray(angles).ravel()) if angles is not None
           else _equi_angles(n_angles, angular_range))
    return CTGeometry("cone", vol, n_angles, n_rows, n_cols,
                      pixel_height, pixel_width, ang, sod=sod, sdd=sdd,
                      center_row=center_row, center_col=center_col,
                      detector_type=detector_type)


def modular_beam(source_pos, det_center, det_u, det_v,
                 n_rows: int, n_cols: int, vol: VolumeGeometry,
                 pixel_width: float = 1.0, pixel_height: float = 1.0) -> CTGeometry:
    source_pos = _as_f32(source_pos)
    n = source_pos.shape[0]
    return CTGeometry("modular", vol, n, n_rows, n_cols,
                      pixel_height, pixel_width, tuple([0.0] * n),
                      source_pos=source_pos, det_center=_as_f32(det_center),
                      det_u=_as_f32(det_u), det_v=_as_f32(det_v))


def helical_beam(n_turns: float, pitch: float, n_angles: int,
                 n_rows: int, n_cols: int, vol: VolumeGeometry,
                 sod: float, sdd: float,
                 pixel_width: float = 1.0, pixel_height: float = 1.0,
                 start_angle: float = 0.0,
                 z_start: Optional[float] = None) -> CTGeometry:
    """Helical (spiral) cone-beam trajectory, expressed as modular frames.

    The source orbits the rotation axis at radius ``sod`` while translating
    along z at ``pitch`` mm per full turn; the detector rides opposite the
    source at distance ``sdd``, rows parallel to the rotation axis (the
    standard diagnostic-CT frame, which the modular Pallas SF pair supports
    on-kernel).  ``n_angles`` views are spread uniformly over
    ``n_turns * 360`` degrees starting at ``start_angle`` (rad).

    ``z_start`` is the source z at the first view; the default starts the
    helix at ``offset_z - span/2`` with ``span = n_turns * pitch``.  Views
    sample the span *endpoint-exclusively*, matching the angular grid (view
    ``i`` sits at fraction ``i/n_angles`` of both the azimuth and the z
    travel), so the last view is one z-step below ``offset_z + span/2`` —
    exactly as the next turn's first view would coincide with it in angle.
    """
    if n_turns <= 0 or pitch < 0:
        raise ValueError(f"need n_turns > 0 and pitch >= 0, "
                         f"got {(n_turns, pitch)}")
    t = np.arange(n_angles) / n_angles                 # [0, 1)
    phi = start_angle + 2.0 * math.pi * n_turns * t
    span = n_turns * pitch
    z0 = (vol.offset_z - span / 2.0) if z_start is None else z_start
    z = z0 + span * t
    c, s = np.cos(phi), np.sin(phi)
    src = np.stack([sod * c, sod * s, z], -1)
    ctr = np.stack([(sod - sdd) * c, (sod - sdd) * s, z], -1)
    du = np.stack([-s, c, np.zeros_like(c)], -1)
    dv = np.stack([np.zeros_like(c), np.zeros_like(c), np.ones_like(c)], -1)
    return modular_beam(src, ctr, du, dv, n_rows, n_cols, vol,
                        pixel_width, pixel_height)


def cone_as_modular(g: CTGeometry) -> CTGeometry:
    """Re-express an axial cone-beam geometry in modular form (for testing the
    modular path against the cone path)."""
    if g.geom_type != "cone" or g.detector_type != "flat":
        raise ValueError(
            f"cone_as_modular needs a flat-detector cone geometry, got "
            f"geom_type={g.geom_type!r} detector_type="
            f"{getattr(g, 'detector_type', None)!r}")
    ang = np.asarray(g.angles)
    c, s = np.cos(ang), np.sin(ang)
    src = np.stack([g.sod * c, g.sod * s, np.zeros_like(c)], -1)
    ctr = np.stack([(g.sod - g.sdd) * c - g.center_col * (-s),
                    (g.sod - g.sdd) * s - g.center_col * c,
                    np.full_like(c, -g.center_row)], -1)
    # det_center is the *physical* location of detector coordinate (u=0,v=0)
    # minus shifts; keep shifts inside u/v coords instead:
    ctr = np.stack([(g.sod - g.sdd) * c, (g.sod - g.sdd) * s, np.zeros_like(c)], -1)
    du = np.stack([-s, c, np.zeros_like(c)], -1)
    dv = np.stack([np.zeros_like(c), np.zeros_like(c), np.ones_like(c)], -1)
    return modular_beam(src, ctr, du, dv, g.n_rows, g.n_cols, g.vol,
                        g.pixel_width, g.pixel_height)


def from_config(cfg: dict) -> CTGeometry:
    """Build a geometry from a plain dict (e.g. parsed from a JSON/YAML file) —
    the paper's 'configuration file' interface."""
    cfg = dict(cfg)
    vol = VolumeGeometry(**cfg.pop("volume"))
    t = cfg.pop("geom_type")
    if t == "parallel":
        return parallel_beam(vol=vol, **cfg)
    if t == "fan":
        return fan_beam(vol=vol, **cfg)
    if t == "cone":
        return cone_beam(vol=vol, **cfg)
    if t == "modular":
        return modular_beam(vol=vol, **cfg)
    if t == "helical":
        # Convenience spelling: the emitted geometry is geom_type="modular"
        # (helical frames are modular frames), but configuration files can
        # carry the compact (n_turns, pitch, sod, sdd) description.
        return helical_beam(vol=vol, **cfg)
    raise ValueError(f"unknown geom_type {t!r}")
