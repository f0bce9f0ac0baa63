"""Ramp filters for FBP/FDK, applied along the detector-column axis via FFT.

Frequencies are physical (cycles/mm, spacing = pixel_width) so reconstructed
values come out in 1/mm.
"""
from __future__ import annotations

import numpy as np
import torch

_WINDOWS = ("ramp", "shepp-logan", "hann", "cosine")


def ramp_kernel_freq(n_pad: int, du: float, filter_name: str = "ramp",
                     equiangular_sdd: float = 0.0) -> np.ndarray:
    """|nu| (cycles/mm) times an apodization window, for rfft of length n_pad.

    Uses the band-limited discrete ramp (Kak & Slaney eq. 61): the DC term of
    the spatial kernel is 1/(4 du^2), which avoids the DC bias of a naive
    |nu| sampling.

    ``equiangular_sdd > 0`` applies the equiangular fan-beam correction
    (Kak & Slaney eq. 92): the spatial kernel taps are multiplied by
    ``(gamma / sin gamma)^2`` with ``gamma = n * du / sdd`` — the ramp for
    data sampled on an arc of radius sdd rather than a line."""
    n = np.arange(-(n_pad // 2), n_pad - n_pad // 2)
    h = np.zeros(n_pad)
    h[n == 0] = 1.0 / (4.0 * du * du)
    odd = n % 2 == 1
    h[odd] = -1.0 / (np.pi * np.pi * n[odd] ** 2 * du * du)
    if equiangular_sdd > 0:
        gam = n * du / equiangular_sdd
        sg = np.sin(gam)
        corr = np.ones_like(h)
        nz = np.abs(sg) > 1e-12
        corr[nz] = (gam[nz] / sg[nz]) ** 2
        # Taps in the zero-padded tail can reach |gamma| ~ pi where the
        # correction diverges; they carry ~1/n^2 energy, so cap the factor.
        h = h * np.clip(corr, 1.0, 10.0)
    H = np.abs(np.fft.rfft(np.fft.ifftshift(h)))  # ~|nu|/du, band-limited
    freq = np.fft.rfftfreq(n_pad, d=du)
    nyq = freq[-1] if freq[-1] > 0 else 1.0
    if filter_name == "ramp":
        w = np.ones_like(freq)
    elif filter_name == "shepp-logan":
        w = np.sinc(freq / (2.0 * nyq))
    elif filter_name == "hann":
        w = 0.5 * (1.0 + np.cos(np.pi * freq / nyq))
    elif filter_name == "cosine":
        w = np.cos(0.5 * np.pi * freq / nyq)
    else:
        raise ValueError(f"unknown filter {filter_name!r}; choose from {_WINDOWS}")
    return (H * w).astype(np.float32)


def filter_sinogram(sino: torch.Tensor, du: float, filter_name: str = "ramp",
                    equiangular_sdd: float = 0.0) -> torch.Tensor:
    """Apply the ramp filter along the last axis (detector columns).

    sino: (..., n_cols).  Zero-pads to the next power of two >= 2*n_cols to
    avoid circular-convolution wrap-around.  ``equiangular_sdd``: see
    :func:`ramp_kernel_freq`."""
    nu = sino.shape[-1]
    n_pad = 1 << int(np.ceil(np.log2(max(2 * nu, 8))))
    H = torch.from_numpy(ramp_kernel_freq(n_pad, du, filter_name,
                                          equiangular_sdd)).to(sino.device)
    S = torch.fft.rfft(sino.to(torch.float32), n=n_pad, dim=-1)
    q = torch.fft.irfft(S * H, n=n_pad, dim=-1)[..., :nu]
    return q.to(sino.dtype) * du
