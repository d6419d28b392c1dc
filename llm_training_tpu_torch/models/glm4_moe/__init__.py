from llm_training_tpu_torch.models.glm4_moe.config import Glm4MoeConfig
from llm_training_tpu_torch.models.glm4_moe.model import Glm4Moe

__all__ = ["Glm4Moe", "Glm4MoeConfig"]
