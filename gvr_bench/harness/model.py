"""The model a cell serves: the port's configuration, checked against the
configuration file, and the weights and restored cache rows the benchmark
draws from the seed on the card.

The port declares the parameter tree's shapes and dtypes
(`build_model(cfg, device="meta")`); the benchmark fills every leaf itself,
one `torch.randn` call a leaf, at the standard deviation the configuration
file gives for it. The same tensors go to the port and to the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from . import seeds

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(conf: Dict[str, Any], overrides: Optional[Dict] = None):
    """The port's `ModelConfig` for a configuration file: its registry
    entry with the file's `port_overrides`, checked against the file's
    `model` block (the equations the reference runs). A registry entry
    that has drifted from the file fails the run."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(conf["registry"], smoke=bool(conf.get("smoke")))
    over = dict(conf.get("port_overrides", {}))
    over.update(overrides or {})
    if over:
        cfg = dataclasses.replace(cfg, **over)
    m = conf["model"]
    seen = {
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "rope_base": cfg.rope_base, "rope_fraction": cfg.rope_fraction,
        "dtype": cfg.dtype, "tie_embeddings": cfg.tie_embeddings,
        "swa_window": cfg.swa_window,
        "dsa": {"k": cfg.dsa.k, "indexer_heads": cfg.dsa.indexer_heads,
                "indexer_dim": cfg.dsa.indexer_dim, "min_n": cfg.dsa.min_n,
                "enabled": cfg.dsa.enabled},
        "moe": (None if not cfg.moe.num_experts else
                {"num_experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                 "expert_d_ff": cfg.moe.expert_d_ff}),
    }
    for key, val in seen.items():
        want = m.get(key)
        if want != val:
            raise RuntimeError(f"config {conf['name']}: the port runs "
                               f"{key}={val!r}, the file states {want!r}")
    return cfg


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from leaves(val, path + "/")
        else:
            yield path, val


def _set(tree, path: str, value) -> None:
    keys = path.split("/")
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


def draw_weights(cfg, conf: Dict[str, Any], seed: int, device,
                 only: Optional[str] = None) -> Dict[str, Any]:
    """Every leaf of the port's parameter tree (or those under the path
    prefix `only`), drawn on `device` from the seed: N(0, std^2) in the
    leaf's dtype with std from `conf["init_std"]`, "ones", or
    "const:<value>". Each leaf has a stream of its own."""
    from repro_torch.models.api import build_model
    shapes = build_model(cfg, device="meta").init_params(0)
    rules = conf["init_std"]
    out: Dict[str, Any] = {}
    for path, meta in leaves(shapes):
        if only is not None and not path.startswith(only):
            continue
        if path not in rules:
            raise RuntimeError(f"config {conf['name']}: no init_std for "
                               f"leaf {path!r}")
        rule = rules[path]
        shape, dtype = tuple(meta.shape), meta.dtype
        if rule == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif isinstance(rule, str) and rule.startswith("const:"):
            t = torch.full(shape, float(rule[6:]), dtype=dtype, device=device)
        else:
            g = seeds.generator(seed, device, "weights", path)
            t = torch.randn(shape, generator=g, dtype=dtype,
                            device=device).mul_(float(rule))
        _set(out, path, t)
    return out


def doc_scale(seed: int, doc, length: int, sigma: float, device,
              tag: str = "doc") -> torch.Tensor:
    """(length,) f32 per-position scale exp(sigma * eps) of one restored
    document: the few high-norm positions stand for persistent heavy
    hitters; sigma = 0 gives a flat document."""
    g = seeds.generator(seed, device, tag, "scale", doc)
    eps = torch.randn((length,), generator=g, device=device)
    return torch.exp(sigma * eps)


def doc_rows(seed: int, doc, layer: int, kind: str, shape_tail, length: int,
             scale: Optional[torch.Tensor], dtype, device,
             tag: str = "doc") -> torch.Tensor:
    """(length, *shape_tail) rows of one kind ("k", "v" or "idx_k") of one
    document at one layer, N(0, 1) times `scale` per position, in dtype.
    The stream is the (document, layer, kind)'s own, so the reference draws
    the same rows again."""
    g = seeds.generator(seed, device, tag, kind, doc, layer)
    rows = torch.randn((length,) + tuple(shape_tail), generator=g,
                       device=device)
    if scale is not None:
        rows.mul_(scale.reshape((length,) + (1,) * len(shape_tail)))
    return rows.to(dtype)
