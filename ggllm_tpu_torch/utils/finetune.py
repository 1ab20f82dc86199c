"""Finetune-flavor detection, prompt templates, and default stopwords (the
port's copy of ggllm_tpu/utils/finetune.py, held to it by
tests/test_torch_generator.py).

Mirrors falcon_detect_finetune (libfalcon.cpp:1497-1523) and the template /
stopword table in falcon_main (falcon_main.cpp:274-410).
"""

from __future__ import annotations


def detect_finetune(model_path: str, vocab) -> str:
    low = model_path.lower()
    if "<|prompter|>" in vocab.special_tokens:
        return "openassistant"
    if vocab.n_vocab in (70144, 70656):
        return "openbuddy"
    if "wizard" in low:
        return "wizard"
    if "oasst1" in low:
        return "openassist_v1"
    if "b-instruct" in low:
        return "falcon_ins"
    return "none"


# finetune -> (prefix, suffix) wrapped around the user prompt
TEMPLATES: dict[str, tuple[str, str]] = {
    "alpaca": ("\n\n### Instruction:\n\n", "\n\n### Response:\n\n"),
    "openassistant": ("<|prompter|>", "<|endoftext|><|assistant|>"),
    "openassist_v1": ("<|prompt|>", "<|endoftext|><|answer|>"),
    "wizard": ("", "\n### Response:"),
    "openbuddy": ("User: ", "\nAssistant:"),
    "falcon_ins": ("User: ", "\nAssistant:"),
    "none": (">>QUESTION<<", "\n>>ANSWER<<"),
}

# finetune -> system prompt wrapper (prefix, suffix)
SYSTEM_TEMPLATES: dict[str, tuple[str, str]] = {
    "alpaca": ("", "\n\n"),
    "openassistant": (">>SUMMARY<<", "<|endoftext|>"),
    "openassist_v1": (">>SUMMARY<<", "<|endoftext|>"),
    "wizard": (">>INTRODUCTION<<", "\n"),
    "openbuddy": (">>INTRODUCTION<<", "\n"),
    "falcon_ins": (">>INTRODUCTION<<", "\n"),
    "none": (">>INTRODUCTION<<", "\n\n"),
}

STOPWORDS: dict[str, list[str]] = {
    "openassistant": ["###", " ###"],
    "openassist_v1": ["###", " ###"],
    "falcon_ins": [
        "Assistant:", " Assistant:", " User:", "User:",
        ".</s>", " .</s>", "</s>", " </s>", "?</s>", " ?</s>",
        "!</s>", " !</s>", "<s>",
    ],
    "none": [">>COMMENT<<", ">>ANSWER<<", ">>QUESTION<<"],
}


def build_prompt(finetune: str, user_prompt: str, system_prompt: str | None) -> str:
    pfx, sfx = TEMPLATES.get(finetune, TEMPLATES["none"])
    out = ""
    if system_prompt:
        spfx, ssfx = SYSTEM_TEMPLATES.get(finetune, SYSTEM_TEMPLATES["none"])
        out += spfx + system_prompt + ssfx
    return out + pfx + user_prompt + sfx


def finetune_stopwords(finetune: str) -> list[str]:
    return list(STOPWORDS.get(finetune, []))
