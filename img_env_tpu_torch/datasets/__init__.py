"""Real-world pedestrian trajectory datasets (ETH/UCY replay), host numpy."""

from img_env_tpu_torch.datasets.pedestrians import (
    PedDatasetConfig,
    build_world,
    build_world_arrays,
    load_trajectory_csv,
)

__all__ = [
    "PedDatasetConfig",
    "load_trajectory_csv",
    "build_world",
    "build_world_arrays",
]
