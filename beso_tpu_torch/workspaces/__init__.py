from beso_tpu_torch.workspaces.block_push_workspace import BlockPushWorkspace
from beso_tpu_torch.workspaces.kitchen_workspace import FrankaKitchenWorkspace

__all__ = ["BlockPushWorkspace", "FrankaKitchenWorkspace"]
