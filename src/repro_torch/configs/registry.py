"""Arch config registry for the PyTorch port: `get_config(<id>)` resolves here.

Each module under repro_torch.configs defines CONFIG (the full published
width) and SMOKE (a reduced same-family config for CPU tests). The port
carries its own copies of the JAX package's configs; only the configs of
the models the port already serves are present so far (the dense, vlm
and MoE families) — the hybrid, ssm and enc-dec archs arrive with their
model families (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import importlib

ARCHS = ["h2o_danube3_4b", "granite_34b", "chatglm3_6b", "llama32_1b",
         "qwen2_vl_7b", "granite_moe_1b", "moonshot_v1_16b"]

_ALIASES = {
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "granite-34b": "granite_34b",
    "chatglm3-6b": "chatglm3_6b",
    "llama3.2-1b": "llama32_1b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
}

# archs of the JAX package that the port does not serve yet
_PENDING = {
    "jamba_15_large", "rwkv6_3b", "whisper_medium", "jamba-1.5-large-398b",
    "rwkv6-3b", "whisper-medium",
}


def get_config(name: str, smoke: bool = False):
    if name in _PENDING:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP Queue A "
            f"item 5); ported archs: {ARCHS}")
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs():
    return list(ARCHS)
