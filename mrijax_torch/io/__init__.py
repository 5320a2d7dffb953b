"""IO: checkpoints with full resume, the portable npz weight export, weight
and train-state exchange with the JAX package's flax trees, the loaders of
reference PyTorch checkpoints, the converters of the evaluation backbones'
torchvision / lpips checkpoints, and PNG writers (``io.images``)."""

from mrijax_torch.io.checkpoint import (
    CheckpointManager,
    load_params_npz,
    load_state,
    save_params_npz,
)
from mrijax_torch.io.flax_convert import (
    conv_feature_net_state_dict_from_flax,
    inception_v3_state_dict_from_flax,
    lpips_state_dict_from_flax,
    resnet18_state_dict_from_flax,
    train_state_from_flax,
    unet2d_state_dict_from_flax,
    unet3d_state_dict_from_flax,
    vae3d_state_dict_from_flax,
)
from mrijax_torch.io.torch_convert import (
    convert_inception_v3,
    convert_lpips_alex,
    convert_reference_unet3d,
    convert_reference_vae3d,
    convert_resnet18,
    infer_timesteps,
    load_reference_unet2d,
    strip_prefixes,
)

__all__ = ["CheckpointManager", "load_params_npz", "load_state", "save_params_npz",
           "conv_feature_net_state_dict_from_flax", "inception_v3_state_dict_from_flax",
           "lpips_state_dict_from_flax", "resnet18_state_dict_from_flax",
           "train_state_from_flax", "unet2d_state_dict_from_flax",
           "unet3d_state_dict_from_flax", "vae3d_state_dict_from_flax",
           "convert_inception_v3", "convert_lpips_alex", "convert_resnet18",
           "convert_reference_unet3d", "convert_reference_vae3d", "infer_timesteps",
           "load_reference_unet2d", "strip_prefixes"]
