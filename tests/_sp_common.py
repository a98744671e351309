"""Shared harness of the sequence-sharded port tests.

The port's sharded path runs SPMD: S processes, one rank each, in a gloo
group on the CPU. `run_ranks` starts them (`_sp_rank.py TASK`, a
`file://` rendezvous under the test's tmp_path, every wait bounded) and
returns each rank's results. The JAX side runs in one subprocess with a
forced host device count (`run_jax`), as the JAX package's own mesh tests
do. Inputs are made here with numpy from a seed and travel as `.npz`.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
RANK_TIMEOUT_S = 240
JAX_TIMEOUT_S = 280


def flatten(tree, prefix=""):
    """Nested dict of arrays → {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat, prefix):
    """The inverse of `flatten` over the keys under `prefix`."""
    tree = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return tree


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "2"
    return env


def run_ranks(task: str, world: int, tmp: Path, timeout_s: int = RANK_TIMEOUT_S):
    """Run `_sp_rank.py task` on `world` gloo ranks over the inputs in
    `tmp`; returns [rank 0's results, ...] (torch.load'ed dicts). A rank
    that fails, or the group outliving `timeout_s`, fails the caller."""
    import torch
    rdv = tmp / f"rdv_{task}_{world}"
    out = tmp / f"out_{task}_{world}"
    out.mkdir(exist_ok=True)
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_sp_rank.py"), task, str(r), str(world),
         f"file://{rdv}", str(tmp), str(out)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=_env(), cwd=str(REPO))
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (r, (out / f"rank{r}.log").read_text()[-4000:])
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def run_jax(script: str, tmp: Path, devices: int = 4):
    """Run a JAX script with `devices` forced host devices; it reads and
    writes under `tmp` (passed as argv[1])."""
    env = _env()
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    r = subprocess.run([sys.executable, "-c", script, str(tmp)],
                       capture_output=True, text=True, env=env,
                       timeout=JAX_TIMEOUT_S, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(tmp / "jax.npz", allow_pickle=True))


def paged_layouts(rng, cfg, b: int, n: int, ps: int, shards: int, lengths):
    """One random logical cache (layers x slots x positions) in both
    layouts: the single-device pools (one page per (slot, logical page),
    shuffled) with their table, and the sharded pools (L, S, PPL+1, ...)
    with a table of shard-local ids (shuffled per shard); plus lengths and
    a feedback state of distinct in-range predictions, slot 0 warm."""
    l, kvh, hd, di = cfg.n_layers, cfg.n_kv_heads, cfg.hd, cfg.dsa.indexer_dim
    kk = min(cfg.dsa.k, n)
    mp = n // ps
    span = mp // shards
    content = {"k": rng.standard_normal((l, b, n, kvh, hd)),
               "v": rng.standard_normal((l, b, n, kvh, hd)),
               "idx_k": rng.standard_normal((l, b, n, di))}
    perm = rng.permutation(b * mp).reshape(b, mp)
    table_sp = np.concatenate(
        [rng.permutation(b * span).reshape(b, span) for _ in range(shards)], 1)
    out = {"table": perm.astype(np.int32), "sp_table": table_sp.astype(np.int32),
           "length": np.asarray(lengths, np.int32)}
    for name, arr in content.items():
        feat = arr.shape[3:]
        single = np.zeros((l, b * mp + 1, ps) + feat, np.float32)
        sharded = np.zeros((l, shards, b * span + 1, ps) + feat, np.float32)
        for bb in range(b):
            for lp in range(mp):
                rows = arr[:, bb, lp * ps:(lp + 1) * ps]
                single[:, perm[bb, lp]] = rows
                sharded[:, lp // span, table_sp[bb, lp]] = rows
        out[f"{name}_pages"] = single
        out[f"sp_{name}_pages"] = sharded
    out["prev_topk"] = np.stack([
        np.stack([np.sort(rng.choice(max(int(x), kk), kk, replace=False))
                  for x in lengths]) for _ in range(l)]).astype(np.int32)
    out["topk_valid"] = np.tile(np.arange(b) == 0, (l, 1))
    return out


def run_jax_and_ranks(script: str, task: str, world: int, tmp: Path):
    """`run_jax(script)` and `run_ranks(task, world)` at once, over the
    same inputs in `tmp`: (the JAX results, the ranks' results)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        jax_out = pool.submit(run_jax, script, tmp, world)
        ranks = pool.submit(run_ranks, task, world, tmp)
        return jax_out.result(), ranks.result()
