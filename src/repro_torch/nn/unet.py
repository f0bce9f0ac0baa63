"""U-Net artifact-removal network (Han & Ye 2018 style), the image-domain
half of the paper's limited-angle model; the counterpart of the reference
package's ``nn/unet.py`` in NCHW (a volume's ``nz`` slices as channels)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn import modules as m


class Block(nn.Module):
    """Two (conv 3x3, group norm, SiLU) stages."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.c1 = m.Conv2d(in_ch, out_ch, generator=generator)
        self.n1 = m.GroupNorm(out_ch)
        self.c2 = m.Conv2d(out_ch, out_ch, generator=generator)
        self.n2 = m.GroupNorm(out_ch)

    def forward(self, x):
        x = m.silu(self.n1(self.c1(x)))
        return m.silu(self.n2(self.c2(x)))


class UpBlock(Block):
    """Nearest upsampling and a conv (``up``), then a ``Block`` over the
    concatenation with the skip."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__(2 * out_ch, out_ch, generator)
        self.up = m.Conv2d(in_ch, out_ch, generator=generator)

    def forward(self, x, skip):
        x = self.up(m.upsample_nearest(x))
        return super().forward(torch.cat([x, skip], dim=1))


class UNet(nn.Module):
    """x (B, in_ch, H, W) -> (B, out_ch, H, W); residual on the first
    ``out_ch`` input channels.  The output head starts at zero, so the
    network starts as the identity (stable when images are in 1/mm, O(0.01),
    while group norm makes the hidden activations O(1))."""

    def __init__(self, base: int = 32, levels: int = 3, in_ch: int = 1,
                 out_ch: int = 1, generator: torch.Generator = None):
        super().__init__()
        chans = [base * (2 ** lvl) for lvl in range(levels)]
        self.levels = nn.ModuleList()
        ch = in_ch
        for cl in chans:
            self.levels.append(Block(ch, cl, generator))
            ch = cl
        self.mid = Block(ch, 2 * ch, generator)
        ch = 2 * ch
        self.ups = nn.ModuleList()
        for cl in reversed(chans):
            self.ups.append(UpBlock(ch, cl, generator))
            ch = cl
        self.out = m.Conv2d(ch, out_ch, k=1, generator=generator)
        with torch.no_grad():
            self.out.weight.zero_()

    def forward(self, x):
        skips = []
        h = x
        for lvl in self.levels:
            h = lvl(h)
            skips.append(h)
            h = m.avg_pool(h)
        h = self.mid(h)
        for up, skip in zip(self.ups, reversed(skips)):
            h = up(h, skip)
        out = self.out(h)
        return out + x[:, :out.shape[1]]
