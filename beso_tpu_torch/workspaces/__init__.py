from beso_tpu_torch.workspaces.kitchen_workspace import FrankaKitchenWorkspace

__all__ = ["FrankaKitchenWorkspace"]
