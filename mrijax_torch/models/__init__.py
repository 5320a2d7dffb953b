"""Model families ported so far: the 3D UNet and the 3D VAE."""

from mrijax_torch.models.unet3d import UNet3D
from mrijax_torch.models.vae3d import VAE3D, Decoder3D, Encoder3D

__all__ = ["UNet3D", "VAE3D", "Encoder3D", "Decoder3D"]
