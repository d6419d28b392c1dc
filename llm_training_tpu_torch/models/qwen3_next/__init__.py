from llm_training_tpu_torch.models.qwen3_next.config import Qwen3NextConfig
from llm_training_tpu_torch.models.qwen3_next.model import Qwen3Next

__all__ = ["Qwen3Next", "Qwen3NextConfig"]
