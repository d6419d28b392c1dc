"""Data modules: seeded batch streams over synthetic, pre-training,
instruction-tuning and preference data.

Counterpart of `llm_training_tpu/data/__init__.py`, with its names. Batches
are numpy dicts with `input_ids`, `labels`, `position_ids` and
`segment_ids` (0 = padding, 1..N = packed documents). Importing this
package imports no HF package: the HF-based modules import `datasets`,
`transformers` and `tokenizers` inside their methods only.
"""

from llm_training_tpu_torch.data.base import BaseDataModule, BaseDataModuleConfig
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.data.hf_based import HFBasedDataModule, HFBasedDataModuleConfig
from llm_training_tpu_torch.data.instruction_tuning import (
    InstructionTuningDataModule,
    InstructionTuningDataModuleConfig,
)
from llm_training_tpu_torch.data.pre_training import (
    PreTrainingDataModule,
    PreTrainingDataModuleConfig,
)
from llm_training_tpu_torch.data.preference_tuning import (
    PreferenceTuningDataModule,
    PreferenceTuningDataModuleConfig,
)

__all__ = [
    "BaseDataModule",
    "BaseDataModuleConfig",
    "DummyDataModule",
    "DummyDataModuleConfig",
    "HFBasedDataModule",
    "HFBasedDataModuleConfig",
    "PreTrainingDataModule",
    "PreTrainingDataModuleConfig",
    "InstructionTuningDataModule",
    "InstructionTuningDataModuleConfig",
    "PreferenceTuningDataModule",
    "PreferenceTuningDataModuleConfig",
]
