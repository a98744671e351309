"""The benchmark's command and files: BENCHMARK.json against the
contract's shapes, every part found by name, the refusals (no card, no
program), and no JAX or JAX package loaded by a run or by the reference."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gvr_bench.harness import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_benchmark_json_keeps_to_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gvr_bench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gvr_bench/")
        assert spec.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and w["name"] not in names
        names.add(w["name"])
        work = spec.workload(w["name"])
        assert (work["config"], work["traffic"]) == (w["config"], w["traffic"])
        assert spec.traffic(w["traffic"])["driver"] in ("engine", "select")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in names
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]].get("workloads", names)
        assert set(m["workloads"]) <= set(moved)
    for cell in names:
        assert any(cell in m.get("workloads", [cell]) for m in b["per_layer"])
        assert sum(cell in m.get("workloads", [cell])
                   for m in b["end_to_end"]) >= 2
    assert len(json.dumps(b)) < 64 * 1024


def test_config_keeps_the_published_widths():
    """chatglm3-6b-128k's published numbers are the ones the port runs:
    nothing is `reduced`, and no width differs."""
    conf = spec.config("chatglm3-6b")
    pub, m = conf["published"], conf["model"]
    assert conf["reduced"] == []
    assert (pub["num_layers"], pub["hidden_size"], pub["ffn_hidden_size"],
            pub["num_attention_heads"], pub["multi_query_group_num"],
            pub["kv_channels"], pub["padded_vocab_size"]) == (
        m["n_layers"], m["d_model"], m["d_ff"], m["n_heads"],
        m["n_kv_heads"], m["head_dim"], m["vocab"])
    assert m["moe"] is None


def test_no_card_refuses_and_prints_nothing():
    """Here there is no card: exit non-zero, no result line."""
    r = subprocess.run([sys.executable, "-m", "gvr_bench.run", "--workload",
                        "chatglm3-6b.select-128k", "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_without_the_program_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and gvr_bench/ cannot run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gvr_bench", tmp_path / "gvr_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-c",
                        "import sys; sys.argv[0] = 'x'; "
                        "from gvr_bench.harness import runner; "
                        "runner.prepare = lambda cell, **k: {}; "
                        "sys.exit(runner.main(['--workload', "
                        "'chatglm3-6b.select-128k', '--seed', '1', "
                        "'--seconds', '1']))"],
                       cwd=tmp_path, capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "not importable" in r.stderr


def test_a_cpu_run_loads_no_jax_and_no_jax_package():
    code = ("import sys, json; sys.path.insert(0, 'gvr_bench/tests'); "
            "import smoke; from gvr_bench.harness import runner; "
            "cell = 'chatglm3-6b.docs-128k'; "
            "out = runner.run(cell, 7, 1.5, True, device='cpu', "
            "parts=smoke.parts(cell)); "
            "print(json.dumps([out['correct'], runner.forbidden_modules(), "
            "sorted({m.split('.')[0] for m in sys.modules})]))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env=dict(_env(), PYTHONPATH="src"))
    assert r.returncode == 0, r.stderr[-2000:]
    correct, found, names = json.loads(r.stdout.strip().splitlines()[-1])
    assert correct is True and found == []
    assert "repro_torch" in names
    assert not {"jax", "jaxlib", "flax", "repro"} & set(names)


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import gvr_bench.reference.model, gvr_bench.reference.select, "
            "gvr_bench.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300, env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    names = eval(r.stdout.strip().splitlines()[-1])
    assert not {"repro_torch", "repro", "jax"} & set(names)


@pytest.mark.cuda
def test_a_smoke_run_on_the_card():
    """On the card: one run of each cell at smoke size is correct."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).parent))
    import smoke
    from gvr_bench.harness import runner
    for cell in [w["name"] for w in spec.benchmark()["workloads"]]:
        out = runner.run(cell, 11, 0.5, True, device="cuda",
                         parts=smoke.parts(cell))
        assert out["correct"], (cell, out["checks"])
