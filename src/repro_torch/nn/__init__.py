"""Recon networks of the port (the reference package's ``nn/``): layers,
the U-Net and CT-Net."""
from repro_torch.nn import modules  # noqa: F401
from repro_torch.nn.ctnet import CTNet
from repro_torch.nn.modules import count_params, params_from_reference
from repro_torch.nn.unet import UNet

__all__ = ["modules", "UNet", "CTNet", "count_params", "params_from_reference"]
