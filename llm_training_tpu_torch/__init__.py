"""PyTorch/CUDA port of `llm_training_tpu`, for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here mirrors
the path and names of its counterpart there. The port imports `torch`,
`numpy` and the standard library only -- never `jax` and nothing of
`llm_training_tpu`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no explicit CPU request they raise (`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Asking for CUDA on a machine without it raises -- the port
    never drops to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
