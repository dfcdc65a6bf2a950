from beso_tpu_torch.data.export import export_multimodal_push, export_relay_kitchen
from beso_tpu_torch.data.slicer import SlicedDataset, make_slices
from beso_tpu_torch.data.trajectories import (TrajectoryData, get_split_idx,
                                             load_multimodal_push, load_relay_kitchen,
                                             split_trajectories,
                                             synthetic_kitchen_data,
                                             synthetic_push_data)

__all__ = ["SlicedDataset", "TrajectoryData", "export_multimodal_push",
           "export_relay_kitchen", "get_split_idx", "load_multimodal_push",
           "load_relay_kitchen", "make_slices", "split_trajectories",
           "synthetic_kitchen_data", "synthetic_push_data"]
