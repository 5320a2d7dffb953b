"""Data layer: NIfTI IO, preprocessing on the device, datasets, loaders,
splits and packed shards. Counterpart of ``mrijax/data``, with the same names."""

from mrijax_torch.data import nifti
from mrijax_torch.data.preprocess import (
    zscore_nonzero,
    preprocess_slice,
    preprocess_slice_batch,
    normalize_volume,
    pad_volume_to_min,
    crop_volume,
)
from mrijax_torch.data.datasets import (
    SliceDataset2D,
    MultiModalSliceDataset25D,
    VolumeDataset3D,
    central_slice_range,
)
from mrijax_torch.data.loader import BatchLoader, take_subset, split_dataset, epoch_permutation
from mrijax_torch.data.split import split_subjects, apply_split, volume_split_indices
from mrijax_torch.data.packing import (
    PackedLatentDataset,
    PackedMultiModalDataset25D,
    PackedSliceDataset,
    PackedVolumeDataset,
    pack_dataset,
    pack_latents,
    pack_multimodal_slices,
    pack_volumes,
)

__all__ = [
    "nifti",
    "zscore_nonzero",
    "preprocess_slice",
    "preprocess_slice_batch",
    "normalize_volume",
    "pad_volume_to_min",
    "crop_volume",
    "SliceDataset2D",
    "MultiModalSliceDataset25D",
    "VolumeDataset3D",
    "central_slice_range",
    "BatchLoader",
    "take_subset",
    "split_dataset",
    "epoch_permutation",
    "split_subjects",
    "apply_split",
    "volume_split_indices",
    "pack_dataset",
    "pack_volumes",
    "pack_multimodal_slices",
    "PackedSliceDataset",
    "PackedVolumeDataset",
    "PackedMultiModalDataset25D",
    "PackedLatentDataset",
    "pack_latents",
]
