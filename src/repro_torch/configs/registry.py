"""Arch config registry for the PyTorch port: `get_config(<id>)` resolves here.

Each module under repro_torch.configs defines CONFIG (the full published
width) and SMOKE (a reduced same-family config for CPU tests). The port
carries its own copies of the JAX package's configs, all ten of them.
"""

from __future__ import annotations

import importlib

ARCHS = ["h2o_danube3_4b", "granite_34b", "chatglm3_6b", "llama32_1b",
         "qwen2_vl_7b", "jamba_15_large", "rwkv6_3b", "granite_moe_1b",
         "moonshot_v1_16b", "whisper_medium"]

_ALIASES = {
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "granite-34b": "granite_34b",
    "chatglm3-6b": "chatglm3_6b",
    "llama3.2-1b": "llama32_1b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "jamba-1.5-large-398b": "jamba_15_large",
    "rwkv6-3b": "rwkv6_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "whisper-medium": "whisper_medium",
}


def get_config(name: str, smoke: bool = False):
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs():
    return list(ARCHS)
