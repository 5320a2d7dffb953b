"""Weight exchange with the JAX package's flax parameter trees."""

from mrijax_torch.io.flax_convert import (
    unet3d_state_dict_from_flax,
    vae3d_state_dict_from_flax,
)

__all__ = ["unet3d_state_dict_from_flax", "vae3d_state_dict_from_flax"]
