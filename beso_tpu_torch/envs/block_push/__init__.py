from beso_tpu_torch.envs.block_push.env import (BlockPushState, block_push_obs,
                                                block_push_reset, block_push_step)

__all__ = ["BlockPushState", "block_push_obs", "block_push_reset", "block_push_step"]
