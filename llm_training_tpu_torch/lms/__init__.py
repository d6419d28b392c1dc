"""Training objectives: CLM, DPO and ORPO (`llm_training_tpu/lms`'s;
GRPO is not ported yet, ROADMAP A.6)."""

from llm_training_tpu_torch.lms.base import BaseLMConfig, ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.lms.dpo import DPO, DPOConfig
from llm_training_tpu_torch.lms.orpo import ORPO, ORPOConfig

__all__ = [
    "BaseLMConfig",
    "ModelProvider",
    "CLM",
    "CLMConfig",
    "DPO",
    "DPOConfig",
    "ORPO",
    "ORPOConfig",
]
