"""Assigned architecture configs (``--arch <id>``).

Every entry is the exact published configuration; ``SHAPES`` are the
assigned input-shape cells.  ``get(name)`` returns the ModelConfig;
``SMOKE(name)`` its reduced same-family variant for CPU tests.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "qwen3_moe_235b", "arctic_480b", "rwkv6_3b", "pixtral_12b", "gemma_7b",
    "qwen3_0_6b", "granite_34b", "starcoder2_3b", "musicgen_medium",
    "recurrentgemma_9b",
]

ALIASES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "arctic-480b": "arctic_480b",
    "rwkv6-3b": "rwkv6_3b",
    "pixtral-12b": "pixtral_12b",
    "gemma-7b": "gemma_7b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-34b": "granite_34b",
    "starcoder2-3b": "starcoder2_3b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

# (name, seq_len, global_batch, mode)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: only these archs run it
LONG_OK = {"rwkv6_3b", "recurrentgemma_9b"}


def get(name: str):
    key = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def smoke(name: str):
    return get(name).smoke()


def cells():
    """All runnable (arch, shape) dry-run cells."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_OK:
                continue
            out.append((a, s))
    return out
