"""Best-fit-decreasing packing of documents into fixed-length rows.

Counterpart of `best_fit_bin_packing`, `best_fit_bin_packing_py` and
`_best_fit_decreasing` in `llm_training_tpu/data/pre_training/datamodule.py`
(the port's `data/pre_training/datamodule.py` imports them from here): pure
Python, numpy and the host packer (`llm_training_tpu_torch/native`), no
HF packages, so the card's machine runs them. A packed row holds whole
documents with segment ids 1..N; the collator pads it with segment id 0.
"""

from __future__ import annotations

import bisect

from llm_training_tpu_torch import native


def best_fit_bin_packing(capacity: int, lengths: list[int]) -> list[list[int]]:
    """Best fit in arrival order, in the host packer (`std::set`,
    O(n log n)) at every size; JAX's dispatcher sends fewer than 64 items
    to Python, which gives the same groups. A failed native build raises."""
    return native.bfd_pack(capacity, lengths)


def best_fit_bin_packing_py(capacity: int, lengths: list[int]) -> list[list[int]]:
    """Best fit in arrival order: each item goes to the bin whose free
    space fits it most tightly (sorted free-space list + bisect); a new bin
    opens when none fits. Returns the item indices of each bin."""
    for length in lengths:
        if length > capacity or length < 0:
            raise ValueError(f"an item exceeds capacity {capacity}")

    groups: list[list[int]] = []
    spaces: list[tuple[int, int]] = []  # sorted (free_space, bin_index)
    for i, length in enumerate(lengths):
        pos = bisect.bisect_left(spaces, (length, -1))
        if pos < len(spaces):
            free, j = spaces.pop(pos)
            groups[j].append(i)
            bisect.insort(spaces, (free - length, j))
        else:
            groups.append([i])
            bisect.insort(spaces, (capacity - length, len(groups) - 1))
    return groups


def best_fit_decreasing(batch: dict[str, list], max_length: int) -> dict[str, list]:
    """Sort the documents of each source by length, longest first, and
    best-fit them into rows of `max_length`; no document spans rows.
    `batch` holds `source`, `input_ids` and `length` lists; the result holds
    `source`, `input_ids`, `segment_ids` and `length` per packed row."""
    out: dict[str, list] = {"source": [], "input_ids": [], "segment_ids": [], "length": []}
    by_source: dict[str, list[int]] = {}
    for i, source in enumerate(batch["source"]):
        by_source.setdefault(source, []).append(i)
    for source, indices in by_source.items():
        indices = sorted(indices, key=lambda i: batch["length"][i], reverse=True)
        lengths = [batch["length"][i] for i in indices]
        for group in best_fit_bin_packing(max_length, lengths):
            ids: list[int] = []
            segs: list[int] = []
            for doc_num, local_idx in enumerate(group, start=1):
                doc = batch["input_ids"][indices[local_idx]]
                ids += doc
                segs += [doc_num] * len(doc)
            out["source"].append(source)
            out["input_ids"].append(ids)
            out["segment_ids"].append(segs)
            out["length"].append(len(ids))
    return out
