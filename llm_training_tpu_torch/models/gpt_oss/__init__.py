from llm_training_tpu_torch.models.gpt_oss.config import GptOssConfig
from llm_training_tpu_torch.models.gpt_oss.model import GptOss

__all__ = ["GptOss", "GptOssConfig"]
