"""Host data pipeline of the port (numpy): S3DIS rooms, the training
block sampler, whole-scene blocks and the synthetic room fixture;
ModelNet shapes and their synthetic fixture in ``data.modelnet``;
RandLA's room preparation, sampler and dataset presets are in
``data.randla``, SemanticKITTI and Semantic3D preparation in
``data.other_datasets``, raw stand-ins of the three datasets in
``data.synthetic_outdoor``; the device-side block sampler in
``data.device_sampler``; the legacy block utilities in ``data.blocks``,
PartNet and the image benchmark sets (readers no CLI reaches)."""

from pointsecguard_tpu_torch.data.image_datasets import (
    ImageClassifierSpec,
    as_batches,
    load_cifar10,
    load_for_classifier,
    load_imagenet_val,
)
from pointsecguard_tpu_torch.data.partnet import PartNetDataset

from pointsecguard_tpu_torch.data.s3dis import (
    NUM_CLASSES,
    S3DIS_CLASSES,
    RoomSet,
    S3DISBlockSampler,
    WholeSceneBlocks,
    inverse_cube_root_weights,
)
from pointsecguard_tpu_torch.data.synthetic import make_room, make_synthetic_rooms

__all__ = [
    "ImageClassifierSpec",
    "NUM_CLASSES",
    "PartNetDataset",
    "RoomSet",
    "S3DIS_CLASSES",
    "S3DISBlockSampler",
    "WholeSceneBlocks",
    "as_batches",
    "inverse_cube_root_weights",
    "load_cifar10",
    "load_for_classifier",
    "load_imagenet_val",
    "make_room",
    "make_synthetic_rooms",
]
