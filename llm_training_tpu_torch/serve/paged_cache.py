"""Paged KV-cache pool and host-side block allocator.

Counterpart of `llm_training_tpu/serve/paged_cache.py`. The pool is the
device half: `[num_layers, num_blocks, block_size, kv_heads, head_dim]` k/v
buffers. Physical block 0 is the reserved TRASH block: idle decode rows and
padded chunk positions write there, never into a live request's cache.
The `BlockAllocator` is the host half: a free list handing fixed-size
blocks to requests and taking them back.

The block size is a fixed default of 16 tokens (`DEFAULT_BLOCK_SIZE`);
the JAX package's TPU tuning table is not carried over.
"""

from __future__ import annotations

import torch

from llm_training_tpu_torch.infer.cache import cache_dims, resolve_cache_dtype

TRASH_BLOCK = 0  # physical block 0 is never allocated
DEFAULT_BLOCK_SIZE = 16


def init_paged_pool(
    model_config,
    num_blocks: int,
    block_size: int,
    device: torch.device | str,
    cache_dtype: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh all-zeros (k, v) pool on `device`."""
    num_layers, kv_heads, head_dim = cache_dims(model_config)
    dtype = resolve_cache_dtype(model_config, cache_dtype)
    shape = (num_layers, num_blocks, block_size, kv_heads, head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def pool_bytes(k: torch.Tensor, v: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in (k, v))


class BlockAllocator:
    """Free list over the pool's physical blocks (block 0 reserved as
    trash). All-or-nothing `alloc`; a double free raises."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 usable + trash), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, TRASH_BLOCK, -1))  # pop() -> low ids first
        self._in_use: set[int] = set()
        self.peak_in_use = 0

    @property
    def blocks_in_use(self) -> int:
        return len(self._in_use)

    def alloc(self, n: int) -> list[int] | None:
        """n blocks, or None (nothing allocated) when fewer are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._in_use.update(blocks)
        self.peak_in_use = max(self.peak_in_use, len(self._in_use))
        return blocks

    def free(self, blocks: list[int]) -> None:
        for block in blocks:
            if block not in self._in_use:
                raise ValueError(f"free of unallocated block {block}")
            self._in_use.remove(block)
            self._free.append(block)
