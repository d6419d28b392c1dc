from llm_training_tpu_torch.models.ernie45_moe.config import Ernie45MoeConfig
from llm_training_tpu_torch.models.ernie45_moe.model import Ernie45Moe

__all__ = ["Ernie45Moe", "Ernie45MoeConfig"]
