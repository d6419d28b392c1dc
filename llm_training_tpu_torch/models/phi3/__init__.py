from llm_training_tpu_torch.models.phi3.config import Phi3Config
from llm_training_tpu_torch.models.phi3.model import Phi3

__all__ = ["Phi3", "Phi3Config"]
