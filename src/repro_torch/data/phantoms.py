"""Synthetic phantoms with *analytic* parallel-beam projections.

The paper's experiments use an airport-luggage dataset that is not
redistributable; the protocol is reproduced on randomized ellipse phantoms
(the standard CT stand-in).  Ellipses also give closed-form line integrals,
which we use as ground truth for the quantitative-accuracy tests:

    p(phi, u) = 2 rho A B sqrt(w^2 - tau^2) / w^2,
    w^2 = A'^2 sin^2(phi-alpha)... (rotated form below)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.geometry import VolumeGeometry


@dataclasses.dataclass(frozen=True)
class Ellipse:
    cx: float
    cy: float
    a: float       # semi-axis along (rotated) x
    b: float       # semi-axis along (rotated) y
    angle: float   # rotation, radians
    rho: float     # density (1/mm)


SHEPP_LOGAN = (
    Ellipse(0.0, 0.0, 0.69, 0.92, 0.0, 1.0),
    Ellipse(0.0, -0.0184, 0.6624, 0.874, 0.0, -0.8),
    Ellipse(0.22, 0.0, 0.11, 0.31, np.deg2rad(-18), -0.2),
    Ellipse(-0.22, 0.0, 0.16, 0.41, np.deg2rad(18), -0.2),
    Ellipse(0.0, 0.35, 0.21, 0.25, 0.0, 0.1),
    Ellipse(0.0, 0.1, 0.046, 0.046, 0.0, 0.1),
    Ellipse(0.0, -0.1, 0.046, 0.046, 0.0, 0.1),
    Ellipse(-0.08, -0.605, 0.046, 0.023, 0.0, 0.1),
    Ellipse(0.0, -0.605, 0.023, 0.023, 0.0, 0.1),
    Ellipse(0.06, -0.605, 0.023, 0.046, 0.0, 0.1),
)


def rasterize(ellipses: Sequence[Ellipse], vol: VolumeGeometry,
              supersample: int = 1) -> np.ndarray:
    """(nx, ny) image of summed densities (antialiased via supersampling).

    Each ellipse is tested only on the samples of its bounding box, widened
    by two samples: outside it the test is false, so the image is the
    reference package's bit for bit, at a fraction of its cost for small
    ellipses."""
    ss = supersample
    nx, ny = vol.nx * ss, vol.ny * ss
    hx, hy = vol.dx / ss, vol.dy / ss
    xs = (np.arange(nx) - (nx - 1) / 2.0) * hx + vol.offset_x
    ys = (np.arange(ny) - (ny - 1) / 2.0) * hy + vol.offset_y
    img = np.zeros((nx, ny), np.float32)
    for e in ellipses:
        ca, sa = np.cos(e.angle), np.sin(e.angle)
        ex = np.hypot(e.a * ca, e.b * sa) + 2 * hx
        ey = np.hypot(e.a * sa, e.b * ca) + 2 * hy
        i0, i1 = np.searchsorted(xs, (e.cx - ex, e.cx + ex))
        j0, j1 = np.searchsorted(ys, (e.cy - ey, e.cy + ey))
        X, Y = xs[i0:i1, None], ys[None, j0:j1]
        xr = (X - e.cx) * ca + (Y - e.cy) * sa
        yr = -(X - e.cx) * sa + (Y - e.cy) * ca
        img[i0:i1, j0:j1] += e.rho * (((xr / e.a) ** 2 + (yr / e.b) ** 2) <= 1.0)
    if ss > 1:
        img = img.reshape(vol.nx, ss, vol.ny, ss).mean(axis=(1, 3))
    return img


def analytic_parallel_projection(ellipses: Sequence[Ellipse],
                                 angles: np.ndarray,
                                 us: np.ndarray) -> np.ndarray:
    """Exact line integrals, shape (n_angles, n_u).

    Detector coordinate convention matches the library: the ray at angle phi,
    detector coordinate u, has direction (cos phi, sin phi) and passes
    through u * (-sin phi, cos phi)."""
    out = np.zeros((len(angles), len(us)), np.float32)
    for e in ellipses:
        for ia, phi in enumerate(angles):
            # center's detector coordinate
            uc = e.cy * np.cos(phi) - e.cx * np.sin(phi)
            # ellipse rotated by `angle`: effective half-width along u-axis
            t = phi - e.angle
            w2 = (e.a * np.sin(t)) ** 2 + (e.b * np.cos(t)) ** 2
            tau = us - uc
            inside = np.maximum(w2 - tau ** 2, 0.0)
            out[ia] += (2.0 * e.rho * e.a * e.b / w2) * np.sqrt(inside)
    return out


def shepp_logan_2d(vol: VolumeGeometry, scale_mm: float = None,
                   supersample: int = 2) -> np.ndarray:
    """Shepp-Logan phantom scaled to the volume's extent."""
    s = scale_mm or 0.48 * min(vol.nx * vol.dx, vol.ny * vol.dy)
    ells = [dataclasses.replace(e, cx=e.cx * s, cy=e.cy * s,
                                a=e.a * s, b=e.b * s) for e in SHEPP_LOGAN]
    return rasterize(ells, vol, supersample)


def random_ellipses(rng: np.random.Generator, vol: VolumeGeometry,
                    n_min: int = 4, n_max: int = 10) -> list:
    """Random ellipse set inside the volume's inscribed circle."""
    R = 0.45 * min(vol.nx * vol.dx, vol.ny * vol.dy)
    n = int(rng.integers(n_min, n_max + 1))
    ells = []
    for _ in range(n):
        r = R * np.sqrt(rng.uniform(0, 0.8))
        th = rng.uniform(0, 2 * np.pi)
        ells.append(Ellipse(
            cx=r * np.cos(th), cy=r * np.sin(th),
            a=rng.uniform(0.05, 0.35) * R, b=rng.uniform(0.05, 0.35) * R,
            angle=rng.uniform(0, np.pi), rho=float(rng.uniform(0.2, 1.0))))
    return ells


def random_ellipse_phantom(seed: int, vol: VolumeGeometry,
                           supersample: int = 2):
    """Returns (image (nx, ny), ellipses) for a deterministic seed."""
    rng = np.random.default_rng(seed)
    ells = random_ellipses(rng, vol)
    return rasterize(ells, vol, supersample), ells
