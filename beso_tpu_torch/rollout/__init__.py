from beso_tpu_torch.rollout.rollout import (RolloutMetrics,
                                            average_success_metric,
                                            rollout_block_push, rollout_kitchen,
                                            success_rate_histogram)

__all__ = ["RolloutMetrics", "average_success_metric", "rollout_block_push",
           "rollout_kitchen", "success_rate_histogram"]
