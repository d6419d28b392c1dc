from llm_training_tpu_torch.models.deepseek.config import DeepseekConfig
from llm_training_tpu_torch.models.deepseek.model import Deepseek

__all__ = ["Deepseek", "DeepseekConfig"]
