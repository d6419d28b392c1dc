"""Chat templates with `{% generation %}` assistant-token masks.

Counterpart of `llm_training_tpu/data/chat_templates/`: the port keeps
byte-for-byte copies of the nine Jinja2 templates beside this module. Their
`{% generation %}` blocks let `tokenizer.apply_chat_template(...,
return_assistant_tokens_mask=True)` mark exactly the assistant's tokens.
A name resolves to a packaged file, else a string holding `{` is taken as
a literal template.
"""

from __future__ import annotations

from pathlib import Path

_TEMPLATE_DIR = Path(__file__).parent


def available_chat_templates() -> list[str]:
    return sorted(p.stem for p in _TEMPLATE_DIR.glob("*.j2"))


def get_chat_template(name_or_template: str) -> str:
    path = _TEMPLATE_DIR / f"{name_or_template}.j2"
    if path.exists():
        return path.read_text()
    if "{" in name_or_template:  # literal jinja template
        return name_or_template
    raise ValueError(
        f"unknown chat template {name_or_template!r}; "
        f"available: {available_chat_templates()}"
    )
