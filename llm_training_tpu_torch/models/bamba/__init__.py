from llm_training_tpu_torch.models.bamba.config import BambaConfig
from llm_training_tpu_torch.models.bamba.model import Bamba

__all__ = ["Bamba", "BambaConfig"]
