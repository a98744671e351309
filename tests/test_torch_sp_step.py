"""The port's sequence-sharded steps — `serve_step_sp_paged` for 4 steps,
then one `serve_step_sp_spec_paged` verify tick by each body — on the
llama3.2-1b smoke config with the JAX parameters, at S = 2 and 4 gloo
ranks on the CPU.

Against the JAX package's sharded steps (one subprocess, a forced
4-device host mesh): tokens, Top-K feedback, telemetry, lengths and the
acceptance equal; logits within rtol = 1e-5, atol = 5e-4 (the port's
bound for whole float32 steps: the frameworks sum in other orders).
Against the port's own single-device `serve_step_paged(paged_attn=
"fused")` and `serve_step_spec_paged` over the same logical cache: every
output bit for bit on every rank, and the rows the steps wrote, read back
through each layout's table, equal to the bit.
"""

import jax
import numpy as np
import pytest
import torch

from _sp_common import flatten, paged_layouts, run_jax, run_ranks
from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models.api import build_model

pytestmark = pytest.mark.mesh

SHARDS = (2, 4)
LENGTHS = {2: [37, 20], 4: [50, 13]}
LOGITS_TOL = dict(rtol=1e-5, atol=5e-4)
FEEDBACK = ("prev_topk", "topk_valid", "sel_gvr", "length")


def _inputs(jparams, shards, rng):
    cfg = get_config("llama3.2-1b", smoke=True)
    lay = paged_layouts(rng, cfg, 2, 64, 8, shards, LENGTHS[shards])
    lay.update(flatten(jax.tree.map(np.asarray, jparams), "params/"))
    lay.update(tokens=np.array([5, 9], np.int32),
               draft=rng.integers(0, cfg.vocab, (2, 3)).astype(np.int32),
               draft_len=np.array([3, 2], np.int32),
               max_accept=np.array([3, 3], np.int32))
    return lay


_JAX = r"""
import sys
from functools import partial
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, "tests")
from _sp_common import unflatten
from repro.configs.registry import get_config
from repro.launch.mesh import make_seq_mesh
from repro.models.transformer import serve_step_sp_paged, serve_step_sp_spec_paged

tmp = sys.argv[1]
cfg = get_config("llama3.2-1b", smoke=True)
out = {}
for s in (2, 4):
    inp = dict(np.load(f"{tmp}/s{s}/inputs.npz"))
    params = jax.tree.map(jnp.asarray, unflatten(inp, "params/"))
    mesh = make_seq_mesh(s)
    state = {k: jnp.asarray(inp["sp_" + k]) for k in ("k_pages", "v_pages", "idx_k_pages")}
    state.update(page_table=jnp.asarray(inp["sp_table"]), length=jnp.asarray(inp["length"]),
                 prev_topk=jnp.asarray(inp["prev_topk"]),
                 topk_valid=jnp.asarray(inp["topk_valid"]),
                 sel_gvr=jnp.zeros(inp["topk_valid"].shape, bool))
    step = jax.jit(partial(serve_step_sp_paged, cfg=cfg, mesh=mesh))
    tok = jnp.asarray(inp["tokens"])
    for i in range(4):
        logits, state = step(params, state, tok)
        out[f"s{s}_step{i}_logits"] = np.asarray(logits)
        for k in ("prev_topk", "topk_valid", "sel_gvr", "length"):
            out[f"s{s}_step{i}_{k}"] = np.asarray(state[k])
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = jnp.concatenate([tok[:, None], jnp.asarray(inp["draft"])], 1)
    for vk in (("scan", "mq") if s == 2 else ("scan",)):
        spec = jax.jit(partial(serve_step_sp_spec_paged, cfg=cfg, mesh=mesh,
                               verify_kernel=vk, eos_id=-1))
        res = spec(params, state, toks, draft_len=jnp.asarray(inp["draft_len"]),
                   max_accept=jnp.asarray(inp["max_accept"]))
        for k, v in zip(("tokens", "accept", "logits", "sel_pos"), res[:4]):
            out[f"s{s}_{vk}_{k}"] = np.asarray(v)
        for k in ("prev_topk", "topk_valid", "sel_gvr", "length"):
            out[f"s{s}_{vk}_{k}"] = np.asarray(res[4][k])
np.savez(tmp + "/jax.npz", **out)
"""


def _fused(inp, model, params):
    """The port's single-device fused run over the same logical cache."""
    t = lambda a: torch.from_numpy(np.array(a, copy=True))
    state = {k: t(inp[k]) for k in ("k_pages", "v_pages", "idx_k_pages")}
    state.update(page_table=t(inp["table"]), length=t(inp["length"]),
                 prev_topk=t(inp["prev_topk"]), topk_valid=t(inp["topk_valid"]),
                 sel_gvr=torch.zeros(inp["topk_valid"].shape, dtype=torch.bool))
    tok = t(inp["tokens"])
    steps = []
    for _ in range(4):
        logits, state = model.serve_step_paged(params, state, tok)
        steps.append({"logits": logits, **{k: state[k] for k in FEEDBACK}})
        tok = logits.argmax(-1).int()
    spec = {}
    for vk in ("scan", "mq"):
        st = {k: v.clone() for k, v in state.items()}
        res = model.serve_step_spec_paged(
            params, st, torch.cat([tok[:, None], t(inp["draft"])], 1),
            draft_len=t(inp["draft_len"]), max_accept=t(inp["max_accept"]),
            verify_kernel=vk)
        spec[vk] = res[:4] + ({k: res[4][k] for k in FEEDBACK},)
    return {"steps": steps, "spec": spec, "state": state}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_step")
    jparams = jax_build(jax_config("llama3.2-1b", smoke=True)).init_params(
        jax.random.PRNGKey(0))
    model = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    inputs, port, fused = {}, {}, {}
    for s in SHARDS:
        (tmp / f"s{s}").mkdir()
        inputs[s] = _inputs(jparams, s, np.random.default_rng(40 + s))
        np.savez(tmp / f"s{s}" / "inputs.npz", **inputs[s])
    jax_out = run_jax(_JAX, tmp)
    for s in SHARDS:
        port[s] = run_ranks("step", s, tmp / f"s{s}")
        fused[s] = _fused(inputs[s], model, params)
    return inputs, jax_out, port, fused


@pytest.mark.parametrize("shards", SHARDS)
def test_sp_steps_bit_identical_to_fused(runs, shards):
    """4 steps: logits, Top-K feedback, telemetry and lengths equal the
    fused single-device step's to the bit, on every rank."""
    _, _, port, fused = runs
    for rank_out in port[shards]:
        for got, want in zip(rank_out["steps"], fused[shards]["steps"]):
            for key, v in want.items():
                assert torch.equal(got[key], v), key


@pytest.mark.parametrize("shards", SHARDS)
def test_sp_steps_equal_jax(runs, shards):
    _, jax_out, port, _ = runs
    for i, got in enumerate(port[shards][0]["steps"]):
        np.testing.assert_allclose(got["logits"].numpy(),
                                   jax_out[f"s{shards}_step{i}_logits"], **LOGITS_TOL)
        np.testing.assert_array_equal(got["logits"].argmax(-1).numpy(),
                                      jax_out[f"s{shards}_step{i}_logits"].argmax(-1))
        for key in FEEDBACK:
            np.testing.assert_array_equal(got[key].numpy(),
                                          jax_out[f"s{shards}_step{i}_{key}"], key)


@pytest.mark.parametrize("shards", SHARDS)
def test_sp_written_rows_equal_fused(runs, shards):
    """The rows the 4 steps wrote (K, V, indexer-K), read through each
    layout's table, are the fused step's to the bit; other rows unchanged."""
    inputs, _, port, fused = runs
    inp = inputs[shards]
    table, sp_table = inp["table"], inp["sp_table"]
    span = sp_table.shape[1] // shards
    for key in ("k_pages", "v_pages", "idx_k_pages"):
        pools = torch.cat([r["pools"][key] for r in port[shards]], 1).numpy()
        single = fused[shards]["state"][key].numpy()
        for b in range(table.shape[0]):
            for lp in range(table.shape[1]):
                np.testing.assert_array_equal(
                    pools[:, lp // span, sp_table[b, lp]],
                    single[:, table[b, lp]], f"{key} slot {b} page {lp}")


@pytest.mark.parametrize("shards,kernel", [(2, "scan"), (2, "mq"), (4, "scan"),
                                           (4, "mq")])
def test_sp_verify_tick(runs, shards, kernel):
    """One verify tick: every output bit-identical to the single-device
    fused tick with the same body, on every rank; against JAX's sharded
    tick (scan at S = 2 and 4, mq at S = 2) tokens, acceptance, telemetry
    and the rolled-back feedback equal, logits within the step bound."""
    _, jax_out, port, fused = runs
    want = fused[shards]["spec"][kernel]
    for rank_out in port[shards]:
        got = rank_out["spec"][kernel]
        for a, b in zip(got[:4], want[:4]):
            assert torch.equal(a, b)
        for key in FEEDBACK:
            assert torch.equal(got[4][key], want[4][key]), key
    pre = f"s{shards}_{kernel}_"
    if pre + "tokens" not in jax_out:
        return
    got = port[shards][0]["spec"][kernel]
    np.testing.assert_array_equal(got[0].numpy(), jax_out[pre + "tokens"])
    np.testing.assert_array_equal(got[1].numpy(), jax_out[pre + "accept"])
    np.testing.assert_allclose(got[2].numpy(), jax_out[pre + "logits"], **LOGITS_TOL)
    np.testing.assert_array_equal(got[3].numpy(), jax_out[pre + "sel_pos"])
    for key in FEEDBACK:
        np.testing.assert_array_equal(got[4][key].numpy(), jax_out[pre + key], key)
