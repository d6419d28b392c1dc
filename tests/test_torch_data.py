"""The port's HF data modules against JAX's on the offline fixtures
(`tests/data_fixtures.py`: the tokenizer trained in process, the text, chat
and preference datasets): the same rows (`source`, `input_ids`, `labels`,
`segment_ids`, `length`, in order), splits, token tables, collated batches,
config errors, tokenizer hashes and chat templates. Nothing is downloaded
and no HF cache outside `tmp_path` is written (`enable_cache: false`)."""

import numpy as np
import pytest

from data_fixtures import chat_dataset, preference_dataset, text_dataset, tiny_tokenizer
from llm_training_tpu.data import hf_based as jax_hf
from llm_training_tpu.data.chat_templates import available_chat_templates as jax_templates
from llm_training_tpu.data.chat_templates import get_chat_template as jax_template
from llm_training_tpu.data.instruction_tuning import InstructionTuningDataModule as JaxIT
from llm_training_tpu.data.instruction_tuning import (
    InstructionTuningDataModuleConfig as JaxITConfig,
)
from llm_training_tpu.data.pre_training import PreTrainingDataModule as JaxPT
from llm_training_tpu.data.pre_training import PreTrainingDataModuleConfig as JaxPTConfig
from llm_training_tpu.data.preference_tuning import PreferenceTuningDataModule as JaxPref
from llm_training_tpu.data.preference_tuning import (
    PreferenceTuningDataModuleConfig as JaxPrefConfig,
)
from llm_training_tpu_torch.cli.config import instantiate_from_config
from llm_training_tpu_torch.data import (
    InstructionTuningDataModule,
    InstructionTuningDataModuleConfig,
    PreferenceTuningDataModule,
    PreferenceTuningDataModuleConfig,
    PreTrainingDataModule,
    PreTrainingDataModuleConfig,
    hf_based,
)
from llm_training_tpu_torch.data.chat_templates import available_chat_templates, get_chat_template

COLUMNS = ("source", "input_ids", "labels", "segment_ids", "length",
           "chosen_input_ids", "chosen_labels", "chosen_length",
           "rejected_input_ids", "rejected_labels", "rejected_length")


def _build(module_cls, config_cls, load, **kwargs):
    module = module_cls(config_cls(tokenizer=tiny_tokenizer(), enable_cache=False, **kwargs))
    module.load_data = load
    return module


CLASSES = {
    "pt": ((PreTrainingDataModule, PreTrainingDataModuleConfig), (JaxPT, JaxPTConfig)),
    "it": ((InstructionTuningDataModule, InstructionTuningDataModuleConfig),
           (JaxIT, JaxITConfig)),
    "pref": ((PreferenceTuningDataModule, PreferenceTuningDataModuleConfig),
             (JaxPref, JaxPrefConfig)),
}


def _pair(kind, load, **kwargs):
    """(port module, JAX module) of one kind on the same config and data."""
    port, jax = CLASSES[kind]
    return _build(*port, load, **kwargs), _build(*jax, load, **kwargs)


def _rows(dataset) -> tuple[list[str], list[tuple]]:
    """The dataset's columns and its rows as tuples of plain values."""
    names = [c for c in COLUMNS if c in dataset.column_names]
    assert sorted(names) == sorted(dataset.column_names)
    return names, [tuple(row[c] for c in names) for row in dataset]


def _assert_same_splits(port, jax):
    assert sorted(port.dataset_dict) == sorted(jax.dataset_dict)
    for split in jax.dataset_dict:
        assert _rows(port.dataset_dict[split]) == _rows(jax.dataset_dict[split]), split


def _setup_both(port, jax):
    port.setup()
    jax.setup()
    _assert_same_splits(port, jax)


# ---------------------------------------------------------------- pre-training


@pytest.mark.parametrize("packing,max_length,stride", [
    ("no_packing", None, None), ("no_packing", 32, None), ("no_packing", 32, 12),
    ("naive_packing", 32, None), ("naive_packing", 32, 12), ("naive_packing", 7, 7),
    ("best_fit_bin_packing", 32, None), ("best_fit_bin_packing", 32, 12),
    ("best_fit_bin_packing", 7, 7),
])
def test_pre_training_rows_match_jax(packing, max_length, stride):
    """Each packing method x stride, 40 documents a source (81 with the
    empty one): best fit packs each source's windows natively and the
    rows equal JAX's."""
    port, jax = _pair("pt", lambda: text_dataset(n_per_source=40), packing_method=packing,
                      max_length=max_length, stride=stride, batch_size=4)
    _setup_both(port, jax)
    assert len(port.train_dataset) > 0


def test_pre_training_sample_rate_and_tokens_table():
    """Replicated and sampled sources (seed 42) after a seed-42 split, and
    the token table's text."""
    port, jax = _pair("pt", lambda: text_dataset(n_per_source=30), max_length=24,
                      packing_method="best_fit_bin_packing", batch_size=2,
                      validation_split=0.2, sample_rate={"wiki": 1.5, "code": 0.5, "gone": 2.0})
    _setup_both(port, jax)
    assert port.tokens_table() == jax.tokens_table()
    assert "wiki" in port.tokens_table() and "validation" in port.tokens_table()


# ---------------------------------------------------------------- instruction tuning


@pytest.mark.parametrize("rate", [None, 0.5], ids=["no-system", "system-0.5"])
@pytest.mark.parametrize("overlong", ["drop", "truncate"])
@pytest.mark.parametrize("packing", ["no_packing", "group_by_length"])
@pytest.mark.parametrize("template", jax_templates())
def test_instruction_tuning_rows_match_jax(template, packing, overlong, rate):
    """Every template x packing x overlong handling x the seeded system
    prompt: equal rows, or the same error where the template refuses the
    conversation (gemma takes no system turn)."""
    extra = {} if rate is None else dict(default_system_prompt="be kind to every user",
                                          add_default_system_prompt_rate=rate)
    # the templates' lengths differ by 10x on the tiny tokenizer: a limit one
    # token over the first example's length drops or cuts some of each
    first = tiny_tokenizer().apply_chat_template(chat_dataset(n=1)["train"][0]["messages"],
                                                 chat_template=jax_template(template))
    port, jax = _pair("it", lambda: chat_dataset(n=16), chat_template=template,
                      max_length=len(first) + 1,
                      packing_method=packing, overlong_handling_method=overlong, batch_size=2,
                      **extra)
    try:
        jax.setup()
    except Exception as e:  # noqa: BLE001 - the reference's own refusal
        with pytest.raises(type(e)):
            port.setup()
        assert template == "gemma" and rate is not None
        return
    port.setup()
    _assert_same_splits(port, jax)
    labels = [label for row in port.train_dataset for label in row["labels"]]
    assert any(t != -100 for t in labels) and -100 in labels


@pytest.mark.parametrize("template", ["chatml", "llama-3.1", "phi-3"])
@pytest.mark.parametrize("max_length", [None, 40])
def test_preference_rows_match_jax(template, max_length):
    port, jax = _pair("pref", lambda: preference_dataset(n=12), chat_template=template,
                      max_length=max_length, batch_size=2)
    _setup_both(port, jax)


# ---------------------------------------------------------------- splits, saving, batches


@pytest.mark.parametrize("split", [5, 0.25, 1], ids=["count", "fraction", "one"])
def test_validation_split_matches_jax(split):
    port, jax = _pair("it", lambda: chat_dataset(n=20), chat_template="chatml",
                      validation_split=split, batch_size=2)
    _setup_both(port, jax)
    n_val = len(port.dataset_dict["validation"])
    assert n_val == (split if split >= 1 else int(20 * split))


def test_save_and_reload_pre_processed_data(tmp_path):
    """The port saves its pre-processed rows, a new module loads them (and
    never loads the raw data); the reloaded train and validation splits
    equal JAX's, which read the same directory."""
    kwargs = dict(max_length=32, packing_method="best_fit_bin_packing", batch_size=4,
                  validation_split=4)
    port, jax = _pair("pt", lambda: text_dataset(n_per_source=20), **kwargs)
    port.setup()
    port.save_pre_processed_data(str(tmp_path / "prep"))

    def refuse():
        raise AssertionError("must not load the raw data")

    again, jax_again = _pair("pt", refuse, pre_processed_data_path=str(tmp_path / "prep"),
                             **kwargs)
    _setup_both(again, jax_again)
    _assert_same_splits(again, port)
    with pytest.raises(ValueError, match="pre_processed_data_path"):
        _pair("pt", refuse, **kwargs)[0].save_pre_processed_data()


@pytest.mark.parametrize("kind", ["pt", "it", "pref"])
def test_collated_batches_match_jax(kind):
    """The first train batches from step 3 (the seeded stream) and every
    validation batch equal JAX's, key by key."""
    data = {"pt": dict(load=lambda: text_dataset(n_per_source=20), max_length=32,
                       packing_method="naive_packing", pad_to_multiple_of=16),
            "it": dict(load=lambda: chat_dataset(n=24), chat_template="chatml", max_length=64,
                       packing_method="group_by_length"),
            "pref": dict(load=lambda: preference_dataset(n=16), chat_template="chatml",
                         pad_to_multiple_of=8)}[kind]
    port, jax = _pair(kind, data.pop("load"), batch_size=2, validation_split=4, **data)
    _setup_both(port, jax)
    batches = [list(zip(range(6), m.train_batches(start_step=3))) for m in (port, jax)]
    batches += [list(m.val_batches()) for m in (port, jax)]
    for got, want in ((batches[0], batches[1]), (batches[2], batches[3])):
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            a, b = (a[1], b[1]) if isinstance(a, tuple) else (a, b)
            assert a.keys() == b.keys()
            for key in b:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ---------------------------------------------------------------- configs, hashes, templates


@pytest.mark.parametrize("kind,kwargs,error", [
    ("pt", dict(packing_method="naive_packing"), "max_length is required"),
    ("pt", dict(packing_method="no_packing", stride=4), "stride requires max_length"),
    ("pt", dict(max_length=8, stride=9), "stride must be <= max_length"),
    ("pt", dict(max_length=8, packing_method="BEST_FIT_BIN_PACKING"), "BEST_FIT_BIN_PACKING"),
    ("it", dict(default_system_prompt="x"), "add_default_system_prompt_rate"),
    ("it", dict(packing_method="group_by_length"), "max_length is required"),
    ("it", dict(chat_template="nope"), "unknown chat template"),
    ("it", dict(max_length=8, packing_method="GROUP_BY_LENGTH"), "GROUP_BY_LENGTH"),
    ("it", dict(overlong_handling_method="clip"), "clip"),
    ("pref", dict(chat_template="nope"), "unknown chat template"),
], ids=["pack-no-max", "stride-no-max", "stride-over", "pt-enum-name", "system-no-rate",
        "group-no-max", "it-template", "it-enum-name", "it-overlong", "pref-template"])
@pytest.mark.parametrize("package", [0, 1], ids=["port", "jax"])
def test_config_errors_match_jax(kind, kwargs, error, package):
    """The port's dataclass configs refuse what JAX's validators refuse (an
    enum by its name too, as pydantic does), with a ValueError naming it."""
    with pytest.raises(ValueError, match=error):
        _build(*CLASSES[kind][package], None, **kwargs)


def test_instantiate_from_a_config_node(tmp_path):
    """The JAX class paths build the port's modules, the tokenizer resolved
    from a saved directory with a pad token of the `{path, pad_token}`
    form; an unknown key raises as JAX's `extra="forbid"` does."""
    tiny_tokenizer().save_pretrained(tmp_path / "tok")
    node = {"class_path": "llm_training_tpu.data.InstructionTuningDataModule",
            "init_args": {"tokenizer": {"path": str(tmp_path / "tok"), "pad_token": "<unk>"},
                          "chat_template": "chatml", "max_length": 64,
                          "packing_method": "group_by_length", "enable_cache": False}}
    module = instantiate_from_config(node)
    assert isinstance(module, InstructionTuningDataModule)
    assert module.config.tokenizer.pad_token == "<unk>"
    assert module.collator.pad_token_id == module.config.tokenizer.pad_token_id
    assert module.config.chat_template == get_chat_template("chatml")
    for name in ("PreTrainingDataModule", "PreferenceTuningDataModule"):
        built = instantiate_from_config({
            "class_path": f"llm_training_tpu.data.{name}",
            "init_args": {"tokenizer": str(tmp_path / "tok"), "max_length": 16}})
        assert type(built).__name__ == name
    with pytest.raises(ValueError, match="unknown field"):
        instantiate_from_config({**node, "init_args": {**node["init_args"], "mesh": 1}})


def test_hash_tokenizer_matches_jax(tmp_path):
    tokenizer = tiny_tokenizer()
    assert hf_based.hash_tokenizer(tokenizer) == jax_hf.hash_tokenizer(tokenizer)
    tokenizer.save_pretrained(tmp_path / "tok")
    from transformers import AutoTokenizer

    reloaded = AutoTokenizer.from_pretrained(tmp_path / "tok")
    assert hf_based.hash_tokenizer(reloaded) == jax_hf.hash_tokenizer(reloaded)


def test_map_fingerprint_is_deterministic_and_the_port_s_own():
    """Two port modules map one dataset to the same fingerprint (the cache
    hits across processes); JAX's module, mapping its own copy of the
    function, gets another: the port's module source is hashed (ROADMAP
    C.32)."""
    from datasets import Dataset, DatasetDict

    from llm_training_tpu.data.instruction_tuning import datamodule as jax_it
    from llm_training_tpu_torch.data.instruction_tuning import datamodule as it

    data = DatasetDict(train=Dataset.from_dict({"length": [3, 1, 2]}))
    prints = []
    for module, function in ((_pair("it", None)[0], it._add_trivial_segments),
                             (_pair("it", None)[0], it._add_trivial_segments),
                             (_pair("it", None)[1], jax_it._add_trivial_segments)):
        module.config.enable_cache = True
        mapped = module.map_dataset_dict(data, function, batched=True)
        assert mapped["train"]["segment_ids"] == [[1, 1, 1], [1], [1, 1]]
        prints.append(mapped["train"]._fingerprint)
    assert prints[0] == prints[1] != prints[2]


def test_chat_templates_are_byte_copies():
    assert available_chat_templates() == jax_templates()
    assert len(available_chat_templates()) == 9
    for name in available_chat_templates():
        assert get_chat_template(name).encode() == jax_template(name).encode(), name
    literal = "{{ messages[0]['content'] }}"
    assert get_chat_template(literal) == jax_template(literal) == literal
    with pytest.raises(ValueError, match="unknown chat template"):
        get_chat_template("nope")
