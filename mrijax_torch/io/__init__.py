"""IO: checkpoints with full resume, the portable npz weight export, and
weight and train-state exchange with the JAX package's flax trees."""

from mrijax_torch.io.checkpoint import (
    CheckpointManager,
    load_params_npz,
    load_state,
    save_params_npz,
)
from mrijax_torch.io.flax_convert import (
    train_state_from_flax,
    unet3d_state_dict_from_flax,
    vae3d_state_dict_from_flax,
)

__all__ = ["CheckpointManager", "load_params_npz", "load_state", "save_params_npz",
           "train_state_from_flax", "unet3d_state_dict_from_flax",
           "vae3d_state_dict_from_flax"]
