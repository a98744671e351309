"""Smoke-sized parts of the benchmark for the CPU tests: the port's smoke
configurations under the cells' mixes, cut to a few hundred positions."""

from __future__ import annotations

import copy

from gvr_bench.harness import spec


def _smoke_conf(name: str, registry: str) -> dict:
    from repro_torch.configs.registry import get_config
    cfg = get_config(registry, smoke=True)
    conf = copy.deepcopy(spec.config(name))
    conf.update(smoke=True, port_overrides={})
    conf["model"] = {
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "rope_base": cfg.rope_base, "rope_fraction": cfg.rope_fraction,
        "norm_eps": 1e-06, "dtype": cfg.dtype, "tie_embeddings": False,
        "swa_window": None, "moe": None,
        "dsa": {"enabled": True, "k": cfg.dsa.k,
                "indexer_heads": cfg.dsa.indexer_heads,
                "indexer_dim": cfg.dsa.indexer_dim, "min_n": cfg.dsa.min_n}}
    d, hd, h = cfg.d_model, cfg.hd, cfg.n_heads
    std = conf["init_std"]
    for key in list(std):
        if isinstance(std[key], float) and key != "embed":
            fan = {"layers/wo": h * hd, "layers/w_down": cfg.d_ff}.get(key, d)
            std[key] = fan ** -0.5
    std["layers/indexer/w"] = f"const:{1 / cfg.dsa.indexer_heads!r}"
    return conf


def parts(cell: str) -> dict:
    """The cell's parts at smoke size (float32 smoke configs, short docs)."""
    work = copy.deepcopy(spec.workload(cell))
    conf = _smoke_conf(work["config"], spec.config(work["config"])["registry"])
    traf = copy.deepcopy(spec.traffic(work["traffic"]))
    if traf["driver"] == "engine":
        traf.update(slots=2, clients=2, max_len=256, page_size=8, docs=3,
                    doc_low=64, doc_high=160, doc_multiple=8, deck=6,
                    out_low=2, out_high=6, check_requests=2, trace_ticks=3)
    else:
        traf.update(rows=4, capacity=4096, page_size=8, start_low=64,
                    start_high=160, trace_steps=2, count_steps=2)
    bench = spec.benchmark()
    return {"workload": work, "config": conf, "traffic": traf,
            "metrics": [m for m in bench["end_to_end"] + bench["per_layer"]
                        if cell in m.get("workloads", [cell])]}
