from llm_training_tpu_torch.models.gemma.config import GemmaConfig
from llm_training_tpu_torch.models.gemma.model import Gemma

__all__ = ["Gemma", "GemmaConfig"]
