from llm_training_tpu_torch.models.minimax.config import MiniMaxConfig
from llm_training_tpu_torch.models.minimax.model import MiniMax

__all__ = ["MiniMax", "MiniMaxConfig"]
