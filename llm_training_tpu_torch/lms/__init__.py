"""Training objectives: CLM, DPO, ORPO and GRPO (`llm_training_tpu/lms`'s)."""

from llm_training_tpu_torch.lms.base import BaseLMConfig, ModelProvider
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.lms.dpo import DPO, DPOConfig
from llm_training_tpu_torch.lms.grpo import GRPO, GRPOConfig
from llm_training_tpu_torch.lms.orpo import ORPO, ORPOConfig

__all__ = [
    "BaseLMConfig",
    "ModelProvider",
    "CLM",
    "CLMConfig",
    "DPO",
    "DPOConfig",
    "GRPO",
    "GRPOConfig",
    "ORPO",
    "ORPOConfig",
]
