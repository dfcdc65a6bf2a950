from beso_tpu_torch.rollout.rollout import (RolloutMetrics,
                                            average_success_metric,
                                            rollout_block_push, rollout_kitchen,
                                            success_rate_histogram)
from beso_tpu_torch.rollout.sequential import rollout_kitchen_sequential

__all__ = ["RolloutMetrics", "average_success_metric", "rollout_block_push",
           "rollout_kitchen", "rollout_kitchen_sequential", "success_rate_histogram"]
