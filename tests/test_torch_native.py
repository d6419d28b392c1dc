"""The port's host packer (`llm_training_tpu_torch/native`) and the pure
functions of its data modules against JAX's: `bfd_pack` and `pad_batch`
against `llm_training_tpu.native` and the Python versions on
hypothesis-drawn inputs (integer outputs equal), the instruction-tuning
collator on its native and numpy paths, the overlong handling and the
group-by-length packer, and a failed build that raises."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llm_training_tpu import native as jax_native
from llm_training_tpu.data.instruction_tuning import datamodule as jax_it
from llm_training_tpu.data.instruction_tuning.collator import (
    InstructionTuningDataCollator as JaxITCollator,
)
from llm_training_tpu.data.pre_training.datamodule import best_fit_bin_packing as jax_bfp
from llm_training_tpu.data.pre_training.datamodule import best_fit_bin_packing_py as jax_bfp_py
from llm_training_tpu_torch import native
from llm_training_tpu_torch.data.instruction_tuning import datamodule as it
from llm_training_tpu_torch.data.instruction_tuning.collator import InstructionTuningDataCollator
from llm_training_tpu_torch.data.pre_training import packing

SETTINGS = settings(max_examples=60, deadline=None)


@st.composite
def _lengths(draw, max_items=300):
    capacity = draw(st.integers(1, 512))
    lengths = draw(st.lists(st.integers(0, capacity), max_size=max_items))
    return capacity, lengths


@SETTINGS
@given(_lengths())
def test_bfd_pack_equals_jax_and_python(case):
    """Arrival order and length-sorted (the packers' order): the port's
    native groups equal JAX's native groups and both Python versions."""
    capacity, lengths = case
    for order in (lengths, sorted(lengths, reverse=True)):
        got = native.bfd_pack(capacity, order)
        assert got == jax_native.bfd_pack(capacity, order)
        assert got == packing.best_fit_bin_packing_py(capacity, order)
        assert got == jax_bfp_py(capacity, order)
        assert packing.best_fit_bin_packing(capacity, order) == jax_bfp(capacity, order)


@pytest.mark.parametrize("lengths", [[5, 11], [11], [3] * 70 + [11], [-1]],
                         ids=["two", "one", "native-size", "negative"])
def test_overlong_item_raises(lengths):
    with pytest.raises(ValueError, match="exceeds capacity 10"):
        native.bfd_pack(10, lengths)
    with pytest.raises(ValueError, match="exceeds capacity 10"):
        packing.best_fit_bin_packing_py(10, lengths)
    with pytest.raises(ValueError, match="exceeds capacity 10"):
        packing.best_fit_bin_packing(10, lengths)


@pytest.mark.parametrize("n", [1, 63, 64])
def test_best_fit_runs_natively_at_every_size(monkeypatch, n):
    """Best fit runs in the host packer on either side of JAX's 64-item
    dispatch threshold, and its groups equal JAX's (Python below 64)."""
    calls = []
    real = native.bfd_pack
    monkeypatch.setattr(native, "bfd_pack", lambda *a: calls.append(a) or real(*a))
    lengths = list(range(1, n + 1))
    assert packing.best_fit_bin_packing(128, lengths) == jax_bfp(128, lengths)
    assert len(calls) == 1


@st.composite
def _rows(draw):
    n = draw(st.integers(1, 6))
    rows = []
    for _ in range(n):
        length = draw(st.integers(1, 24))
        tokens = draw(st.lists(st.integers(0, 999), min_size=length, max_size=length))
        steps = draw(st.lists(st.integers(0, 1), min_size=length, max_size=length))
        rows.append((tokens, np.cumsum([1] + steps[1:]).tolist(),
                     draw(st.lists(st.sampled_from([-100, 5, 7]), min_size=length,
                                   max_size=length))))
    extra = draw(st.integers(0, 5))
    return rows, max(len(r[0]) for r in rows) + extra


@SETTINGS
@given(_rows(), st.booleans(), st.booleans(), st.booleans())
def test_pad_batch_equals_jax(case, with_segments, with_labels, restart):
    rows, width = case
    tokens = [np.asarray(r[0], np.int32) for r in rows]
    segments = [np.asarray(r[1], np.int32) for r in rows] if with_segments else None
    labels = [np.asarray(r[2], np.int32) for r in rows] if with_labels else None
    got = native.pad_batch(tokens, segments, labels, width, 3, restart_positions=restart)
    want = jax_native.pad_batch(tokens, segments, labels, width, 3, restart_positions=restart)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == np.int32 and got[key].shape == (len(rows), width)
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _config(multiple):
    import types

    return types.SimpleNamespace(tokenizer=types.SimpleNamespace(pad_token_id=2),
                                 pad_to_multiple_of=multiple)


@SETTINGS
@given(_rows(), st.sampled_from(["right", "left"]), st.sampled_from([None, 8]),
       st.booleans())
def test_instruction_collator_equals_jax(case, side, multiple, shuffled):
    """Native path (right padding, ids that never decrease) and numpy path
    (left padding, or ids out of order) both equal JAX's collator, and the
    native path equals the port's own numpy loop."""
    rows, _ = case
    examples = [{"input_ids": r[0], "labels": r[2],
                 "segment_ids": r[1][::-1] if shuffled else r[1]} for r in rows]
    ours = InstructionTuningDataCollator(_config(multiple), side)
    got = ours(examples)
    want = JaxITCollator(_config(multiple), side)(examples)
    plain = ours.plain(examples, got["input_ids"].shape[1])
    for key in ("input_ids", "labels", "segment_ids", "position_ids"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(got[key], plain[key], err_msg=key)


@st.composite
def _examples(draw):
    n = draw(st.integers(0, 80))
    lengths = draw(st.lists(st.integers(1, 40), min_size=n, max_size=n))
    ids = [list(range(k, k + n_)) for k, n_ in enumerate(lengths)]
    labels = [[t if t % 3 else -100 for t in row] for row in ids]
    return {"input_ids": ids, "labels": labels, "length": lengths}


@SETTINGS
@given(_examples(), st.sampled_from(["drop", "truncate"]), st.integers(8, 48))
def test_overlong_and_packing_equal_jax(batch, method, max_length):
    """`_handle_overlong`, then `_group_by_length_packing` (the host
    packer) or `_add_trivial_segments`: the same rows as JAX's."""
    handled = it._handle_overlong(batch, max_length, method)
    assert handled == jax_it._handle_overlong(batch, max_length, method)
    assert it._group_by_length_packing(handled, max_length) == \
        jax_it._group_by_length_packing(handled, max_length)
    assert it._add_trivial_segments(handled) == jax_it._add_trivial_segments(handled)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output (JAX
    falls back to Python; the port does not), and nothing half-built is
    left in the build directory."""
    broken = tmp_path / "packing.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        native.bfd_pack(10, [1, 2])
    with pytest.raises(RuntimeError, match="build failed"):
        packing.best_fit_bin_packing(10, [1] * 64)
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == ["build.lock"]


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="build failed"):
        native.lib()


def test_source_is_the_reference_algorithm():
    """The port's copy of `native/packing.cc` differs from JAX's in its
    header comment only."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    ours = native.SOURCE.read_text()
    theirs = (root / "native" / "packing.cc").read_text()
    assert ours[ours.index("#include"):] == theirs[theirs.index("#include"):]
