"""Image quality metrics (PSNR / SSIM) used by the paper's §4 evaluation.

They take numpy arrays or tensors on any device and compute in float64 on
the host."""
from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import uniform_filter


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def psnr(x, ref, peak: float = None) -> float:
    x, ref = _f64(x), _f64(ref)
    peak = float(ref.max() - ref.min()) if peak is None else peak
    mse = float(np.mean((x - ref) ** 2))
    return 10.0 * np.log10(peak ** 2 / max(mse, 1e-20))


def ssim(x, ref, peak: float = None, win: int = 7) -> float:
    """Mean SSIM with a uniform window (Wang et al. 2004 simplified)."""
    x, ref = _f64(x), _f64(ref)
    peak = float(ref.max() - ref.min()) if peak is None else peak
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    mu_x = uniform_filter(x, win)
    mu_y = uniform_filter(ref, win)
    sxx = uniform_filter(x * x, win) - mu_x ** 2
    syy = uniform_filter(ref * ref, win) - mu_y ** 2
    sxy = uniform_filter(x * ref, win) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)
    return float(np.mean(num / den))
