from beso_tpu_torch.rollout.rollout import (RolloutMetrics,
                                            average_success_metric,
                                            rollout_block_push, rollout_kitchen,
                                            success_rate_histogram)
from beso_tpu_torch.rollout.sequential import rollout_kitchen_sequential
from beso_tpu_torch.rollout.sharded import (rollout_block_push_sharded,
                                            rollout_kitchen_sharded)

__all__ = ["RolloutMetrics", "average_success_metric", "rollout_block_push",
           "rollout_block_push_sharded", "rollout_kitchen", "rollout_kitchen_sequential",
           "rollout_kitchen_sharded", "success_rate_histogram"]
