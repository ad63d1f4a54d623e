"""Host data pipeline of the port (numpy): S3DIS rooms, the training
block sampler, whole-scene blocks and the synthetic room fixture;
ModelNet shapes and their synthetic fixture in ``data.modelnet``;
RandLA's room preparation, sampler and dataset presets are in
``data.randla``, SemanticKITTI and Semantic3D preparation in
``data.other_datasets``, raw stand-ins of the three datasets in
``data.synthetic_outdoor``."""

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
    "NUM_CLASSES",
    "RoomSet",
    "S3DIS_CLASSES",
    "S3DISBlockSampler",
    "WholeSceneBlocks",
    "inverse_cube_root_weights",
    "make_room",
    "make_synthetic_rooms",
]
