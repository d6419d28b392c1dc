"""Batched KV-cache generation engine.

Counterpart of `llm_training_tpu/infer/engine.py` (`GenerateConfig`,
`_left_pad`, `InferenceEngine.generate`). Two kinds of model call run
against one dense cache (`models/base.py:DecodeState`), which they update
in place:

- prefill: the whole left-padded prompt batch at full width, writing every
  prompt position's k/v and sampling the first new token from the last
  column's logits;
- a decode step: one token per row, appended at the shared index.

Prompts are LEFT-padded to a common width so the whole batch shares one
append index; per-row RoPE positions subtract the pad length, and pad
slots carry segment id 0 so the mask never reaches them. Call n of a
generation samples under `fold_in(key(seed), n)` (prefill is call 0), as
the JAX engine does: the same seed gives its tokens.

The dense-cache attention is the plain einsum path, as in the reference
(`models/llama/model.py:275-276` of the JAX package): it is not a kernel
there either.
"""

from __future__ import annotations

import inspect
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from llm_training_tpu_torch import prng, resolve_device
from llm_training_tpu_torch.infer.cache import cache_bytes, init_decode_state
from llm_training_tpu_torch.infer.sampling import SamplingConfig, sample_tokens_with_logprob

logger = logging.getLogger(__name__)


@dataclass
class GenerateConfig:
    """Knobs of one `generate` call."""

    max_new_tokens: int = 32
    # cache capacity; default = padded prompt width + max_new_tokens
    max_length: int | None = None
    # None/'param' = the model's param dtype; 'float32' | 'bfloat16'
    cache_dtype: str | None = None
    seed: int = 0
    # stop a row at this token; generation ends early once every row stopped
    eos_token_id: int | None = None
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.max_length is not None and self.max_length < 1:
            raise ValueError(f"max_length must be >= 1, got {self.max_length}")


def _left_pad(prompts: Sequence[Sequence[int]], pad_id: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (input_ids [B, P] left-padded, pad_lens [B])."""
    if len(prompts) == 0:
        raise ValueError("generate() needs at least one prompt")
    lengths = [len(p) for p in prompts]
    if min(lengths) == 0:
        raise ValueError("empty prompt: each prompt needs at least one token")
    width = max(lengths)
    ids = np.full((len(prompts), width), pad_id, np.int32)
    for row, prompt in enumerate(prompts):
        ids[row, width - len(prompt):] = np.asarray(prompt, np.int32)
    return ids, np.asarray([width - n for n in lengths], np.int32)


def supports_decoding(model: Any) -> bool:
    """JAX's rule: a model family decodes with a KV cache when its forward
    takes a `decode_state` (the Llama, Phi-3 and Gemma stacks do; the
    non-Llama MoE families, whose JAX `__call__` takes none, do not)."""
    try:
        return "decode_state" in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        return False


class InferenceEngine:
    """Drives a model (with its weights, on `device`: `cuda` unless the
    caller asks for the CPU) over prefill and decode steps. A model that
    cannot decode raises `NotImplementedError` with JAX's message."""

    def __init__(self, model: torch.nn.Module, device: torch.device | str | None = None):
        if not supports_decoding(model):
            raise NotImplementedError(
                f"{type(model).__name__} does not support KV-cache decoding "
                "yet: its __call__ takes no decode_state (non-standard "
                "sequence mixers need their own cache layout — see "
                "docs/inference.md)"
            )
        device = resolve_device(device)
        param_device = next(model.parameters()).device
        if param_device.type != device.type:
            raise ValueError(f"model lives on {param_device}, engine asked for {device}")
        self.model = model
        self.device = param_device

    def _step(self, ids, segment_ids, position_ids, state, key, sampling):
        out = self.model(input_ids=ids, segment_ids=segment_ids, position_ids=position_ids,
                         decode_state=state)
        logits = out.logits[:, -1, :].float()
        token, logprob = sample_tokens_with_logprob(logits, key, sampling)
        return out.decode_state, token, logprob

    @torch.no_grad()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        config: GenerateConfig | None = None,
    ) -> dict[str, Any]:
        """-> {"tokens": new tokens per row (truncated after eos),
        "logprobs": chosen-token logprobs per row (aligned with "tokens"),
        "sequences": prompt + new tokens, "lengths": generated count per
        row, "stop_reasons": "eos" | "max_tokens" per row, "stats": decode
        telemetry}."""
        config = config or GenerateConfig()
        model_config = self.model.config
        pad_id = model_config.pad_token_id or 0
        ids, pad_lens = _left_pad(prompts, pad_id)
        batch, width = ids.shape
        max_length = config.max_length or width + config.max_new_tokens
        if max_length < width + config.max_new_tokens:
            raise ValueError(
                f"max_length {max_length} cannot hold the padded prompt "
                f"({width}) plus max_new_tokens ({config.max_new_tokens})"
            )
        # length-dependent RoPE variants select their tables from the length
        # the generation will reach, not the cache's capacity
        state = init_decode_state(model_config, batch, max_length,
                                  cache_dtype=config.cache_dtype, device=self.device,
                                  rope_length=width + config.max_new_tokens)
        # a prompt may contain pad_id, so padding is positional (the
        # left-pad region), not by value
        columns = np.arange(width)[None, :]
        segment_ids = (columns >= pad_lens[:, None]).astype(np.int32)
        position_ids = np.maximum(columns - pad_lens[:, None], 0)

        def to_device(array):
            return torch.as_tensor(array, device=self.device)

        pad = to_device(pad_lens).long()
        ones = torch.ones((batch, 1), dtype=torch.int32, device=self.device)
        sampling = config.sampling
        rng = prng.key(config.seed)
        t0 = time.perf_counter()
        state, token, logprob = self._step(
            to_device(ids).long(), to_device(segment_ids), to_device(position_ids).long(),
            state, prng.fold_in(rng, 0), sampling,
        )
        new_tokens, new_logprobs = [token.cpu().numpy()], [logprob.cpu().numpy()]
        prefill_s = time.perf_counter() - t0

        def decode(step, token):
            # per-row RoPE position: absolute cache slot minus left-pad
            positions = (state.index - pad)[:, None]
            return self._step(token[:, None], ones, positions, state,
                              prng.fold_in(rng, step), sampling)

        eos = config.eos_token_id
        steady_steps, steady_s = 0, 0.0
        if eos is not None:
            # early stop needs each token on the host: the per-step fetch
            # is the stop check
            step_times: list[float] = []
            for step in range(1, config.max_new_tokens):
                t_step = time.perf_counter()
                state, token, logprob = decode(step, token)
                new_tokens.append(token.cpu().numpy())
                step_times.append(time.perf_counter() - t_step)
                new_logprobs.append(logprob.cpu().numpy())
                if all(eos in row for row in np.stack(new_tokens, 1)):
                    break
            steady = step_times[1:] if len(step_times) > 1 else step_times
            steady_steps, steady_s = len(steady), sum(steady)
        else:
            # no stop token: free-running, one fence at the end; the first
            # decode step is fenced apart so it stays out of the steady rate
            device_tokens, device_logprobs = [], []
            for step in range(1, config.max_new_tokens):
                state, token, logprob = decode(step, token)
                device_tokens.append(token)
                device_logprobs.append(logprob)
                if step == 1:
                    token.cpu()
                    t_steady = time.perf_counter()
            new_tokens += [t.cpu().numpy() for t in device_tokens]  # the fence
            new_logprobs += [t.cpu().numpy() for t in device_logprobs]
            if config.max_new_tokens > 2:
                steady_s = time.perf_counter() - t_steady
                steady_steps = config.max_new_tokens - 2
        grid = np.stack(new_tokens, axis=1)  # [B, T]
        lp_grid = np.stack(new_logprobs, axis=1)

        tokens, logprobs, sequences, lengths, stop_reasons = [], [], [], [], []
        for row in range(batch):
            emitted = [int(t) for t in grid[row]]
            if eos is not None and eos in emitted:
                emitted = emitted[: emitted.index(eos) + 1]
                stop_reasons.append("eos")
            else:
                stop_reasons.append("max_tokens")
            tokens.append(emitted)
            logprobs.append([float(v) for v in lp_grid[row, : len(emitted)]])
            lengths.append(len(emitted))
            sequences.append(list(prompts[row]) + emitted)

        decode_tps = batch * steady_steps / steady_s if steady_s > 0 else 0.0
        stats = {
            "decode/prefill_time_s": prefill_s,
            "decode/tokens_per_sec": decode_tps,
            "decode/new_tokens": int(sum(len(t) for t in tokens)),
            "decode/cache_bytes": cache_bytes(state),
            "decode/max_length": max_length,
        }
        logger.info(
            "generate: %d prompts, %d new tokens | prefill %.3fs | %.1f tokens/s decode",
            batch, stats["decode/new_tokens"], prefill_s, decode_tps,
        )
        return {
            "tokens": tokens,
            "logprobs": logprobs,
            "sequences": sequences,
            "lengths": lengths,
            "stop_reasons": stop_reasons,
            "stats": stats,
        }
