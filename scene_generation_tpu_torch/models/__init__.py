from scene_generation_tpu_torch.models.layers import init_weights
from scene_generation_tpu_torch.models.model import ModelOutput, SceneModel

__all__ = ["ModelOutput", "SceneModel", "init_weights"]
