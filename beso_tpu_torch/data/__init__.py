from beso_tpu_torch.data.slicer import SlicedDataset, make_slices
from beso_tpu_torch.data.trajectories import (TrajectoryData, get_split_idx,
                                             split_trajectories,
                                             synthetic_kitchen_data)

__all__ = ["SlicedDataset", "TrajectoryData", "get_split_idx", "make_slices",
           "split_trajectories", "synthetic_kitchen_data"]
