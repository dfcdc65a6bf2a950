from beso_tpu_torch.data.trajectories import (TrajectoryData, get_split_idx,
                                             synthetic_kitchen_data)

__all__ = ["TrajectoryData", "get_split_idx", "synthetic_kitchen_data"]
