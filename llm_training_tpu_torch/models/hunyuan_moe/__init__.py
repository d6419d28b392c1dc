from llm_training_tpu_torch.models.hunyuan_moe.config import HunYuanMoeConfig
from llm_training_tpu_torch.models.hunyuan_moe.model import HunYuanMoe

__all__ = ["HunYuanMoe", "HunYuanMoeConfig"]
