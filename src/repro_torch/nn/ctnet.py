"""CT-Net-style sinogram completion network (Anirudh et al. 2018,
simplified), the projection-domain half of the paper's hybrid
limited-angle model; the counterpart of the reference package's
``nn/ctnet.py``."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn import modules as m


class CTLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.c = m.Conv2d(in_ch, out_ch, generator=generator)
        self.n = m.GroupNorm(out_ch)

    def forward(self, x):
        return m.silu(self.n(self.c(x)))


class CTNet(nn.Module):
    """(sino, mask), each (B, n_angles, n_cols) -> the completed sinogram
    (B, n_angles, n_cols).  Input channels are [sino, mask]; layer i has
    ``base * 2**min(i, 2)`` channels.  Measured views pass through
    unchanged; only the missing ones are predicted."""

    def __init__(self, base: int = 32, depth: int = 4,
                 generator: torch.Generator = None):
        super().__init__()
        self.layers = nn.ModuleList()
        ch = 2
        for i in range(depth):
            cl = base * (2 ** min(i, 2))
            self.layers.append(CTLayer(ch, cl, generator))
            ch = cl
        self.out = m.Conv2d(ch, 1, k=1, generator=generator)

    def forward(self, sino, mask):
        h = torch.stack([sino, mask], dim=1)
        for layer in self.layers:
            h = layer(h)
        pred = self.out(h)[:, 0]
        return mask * sino + (1.0 - mask) * pred
