"""The port's paged decode step vs the JAX package's, on the llama3.2-1b
smoke config (float32) with the JAX parameters from `init_params(
PRNGKey(0))` carried over through `repro_torch.bridge`.

Per step and per layer, `prev_topk`, `topk_valid` and `sel_gvr` must be
equal and the greedy tokens equal. Logits agree to float32 rounding: the
frameworks order the sums of their matmuls and reductions differently and
their transcendental functions differ in the last bit; on logits of scale
~10 that leaves differences of ~1e-5, bounded here by atol = 5e-4,
rtol = 1e-5. Both regimes run: DSA (max_len > dsa.min_n) and the dense
pre-DSA fallback (max_len <= dsa.min_n).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer
from repro_torch.models.api import build_model


@pytest.fixture(scope="module")
def jax_model_params():
    model = jax_build(jax_config("llama3.2-1b", smoke=True))
    return model, model.init_params(jax.random.PRNGKey(0))


def _configs(min_n):
    jcfg = jax_config("llama3.2-1b", smoke=True)
    tcfg = get_config("llama3.2-1b", smoke=True)
    if min_n is not None:
        jcfg = dataclasses.replace(jcfg, dsa=dataclasses.replace(jcfg.dsa, min_n=min_n))
        tcfg = dataclasses.replace(tcfg, dsa=dataclasses.replace(tcfg.dsa, min_n=min_n))
    return jcfg, tcfg


@pytest.mark.parametrize("regime,min_n", [("dsa", None), ("dense", 64)])
def test_serve_step_paged_matches_jax(jax_model_params, regime, min_n):
    jm, jparams = jax_model_params
    jcfg, tcfg = _configs(min_n)
    jm = jax_build(jcfg)
    tm = build_model(tcfg, device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    b, max_len, ps, steps = 3, 64, 8, 24
    mp = max_len // ps
    js = jm.init_paged_decode_state(b, max_len, num_pages=b * mp, page_size=ps)
    ts = tm.init_paged_decode_state(b, max_len, num_pages=b * mp, page_size=ps)
    rng = np.random.default_rng(3)
    table = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    js["page_table"] = jnp.asarray(table)
    ts["page_table"] = torch.from_numpy(table)
    # slot 2 joins late: its length starts past the others' and it is cold
    lengths = np.array([0, 0, 10], np.int32)
    js["length"] = jnp.asarray(lengths)
    ts["length"] = torch.from_numpy(lengths)
    step = jax.jit(lambda p, s, t, m: jm.serve_step_paged(p, s, t, min_write_pos=m))
    for t in range(steps):
        tok = rng.integers(0, tcfg.vocab, (b,)).astype(np.int32)
        mwp = np.array([0, 0, 0 if t % 5 else 2 ** 30], np.int32)   # masked writes
        jl, js = step(jparams, js, jnp.asarray(tok), jnp.asarray(mwp))
        tl, ts = tm.serve_step_paged(tparams, ts, torch.from_numpy(tok),
                                     min_write_pos=torch.from_numpy(mwp))
        for key in ("prev_topk", "topk_valid", "sel_gvr", "length"):
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                          err_msg=f"{key} step {t}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=5e-4)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    for key in ("k_pages", "v_pages", "idx_k_pages"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert bool(np.asarray(js["sel_gvr"]).any()) == (regime == "dsa")


def test_slot_hooks_match_jax(jax_model_params):
    jm, _ = jax_model_params
    tm = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    js = jm.init_paged_decode_state(2, 64, num_pages=16, page_size=8)
    ts = tm.init_paged_decode_state(2, 64, num_pages=16, page_size=8)
    js = jm.recycle_slot_state(jm.reset_slot_state(js, 1, seq_len_hint=9), 0)
    ts = tm.recycle_slot_state(tm.reset_slot_state(ts, 1, seq_len_hint=9), 0)
    for key in ("prev_topk", "topk_valid", "sel_gvr", "length", "page_table"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]), err_msg=key)
    assert tm.paged_state_batch_axes() == jm.paged_state_batch_axes()


def test_bridge_carries_bf16_exactly():
    x = np.asarray(jnp.asarray(np.random.default_rng(0).normal(size=(4, 5)),
                               jnp.bfloat16))
    t = bridge.to_torch(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    tree = bridge.params_from_numpy({"a": {"b": x}, "c": np.arange(3)})
    assert tree["c"].dtype == torch.int64 and tree["a"]["b"].shape == (4, 5)
    # the MoE tree (f32 router, bf16 experts) leaf by leaf, value for value
    jcfg = dataclasses.replace(jax_config("moonshot-v1-16b-a3b", smoke=True),
                               dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jax_build(jcfg).init_params(
        jax.random.PRNGKey(0)))
    tparams = bridge.params_from_numpy(jparams)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tparams
        for p in path:
            node = node[p.key]
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(node.float().numpy(), leaf.astype(np.float32))
    assert tparams["layers"]["router"].dtype == torch.float32
    assert tparams["layers"]["w_gate"].dtype == torch.bfloat16


def test_init_params_layout_matches_jax(jax_model_params):
    """Leaf by leaf, the port's init has the JAX init's tree, shapes and
    dtypes: llama3.2-1b's smoke config, the two MoE smoke configs and the
    rest of the dense family's (qwen2-vl's patch_proj included)."""
    _, llama_params = jax_model_params
    for arch in ("llama3.2-1b", "granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
                 "h2o-danube-3-4b", "chatglm3-6b", "granite-34b", "qwen2-vl-7b"):
        jparams = (llama_params if arch == "llama3.2-1b" else
                   jax_build(jax_config(arch, smoke=True)).init_params(
                       jax.random.PRNGKey(0)))
        tm = build_model(get_config(arch, smoke=True), device="cpu")
        tparams = tm.init_params(seed=0)
        leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
        assert len(leaves) == len(jax.tree_util.tree_leaves(tparams)), arch
        for path, leaf in leaves:
            node = tparams
            for p in path:
                node = node[p.key]
            assert tuple(node.shape) == tuple(leaf.shape), (arch, path)
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), (arch, path)


def test_unported_families_and_options_raise():
    """No family is pending: the hybrid, enc-dec and ssm configs are the
    JAX registry's field for field and build on the CPU, and the engine
    refuses the three step-only families (audio, ssm, hybrid) with the
    reference's ValueError; a config of another family is no
    transformer-family config."""
    from repro.serve import DecodeEngine as JaxEngine
    from repro_torch.serve import DecodeEngine
    cfg = get_config("llama3.2-1b", smoke=True)
    with pytest.raises(NotImplementedError, match="not a transformer-family"):
        transformer.init_decode_state(dataclasses.replace(cfg, family="hybrid"),
                                      2, 16, device="cpu")
    for arch, family in (("jamba-1.5-large-398b", "hybrid"),
                         ("whisper-medium", "audio"), ("rwkv6-3b", "ssm")):
        for smoke in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                    == dataclasses.asdict(jax_config(arch, smoke=smoke)))
        assert get_config(arch).family == family
        tm = build_model(get_config(arch, smoke=True), device="cpu")
        assert tm.cfg.family == family
        jm = jax_build(jax_config(arch, smoke=True))
        msgs = []
        for engine, model, params in (
                (JaxEngine, jm, jm.init_params(jax.random.PRNGKey(0))),
                (DecodeEngine, tm, tm.init_params(seed=0))):
            with pytest.raises(ValueError) as err:
                engine(model, params, num_slots=2, max_len=64)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], arch
    assert get_config("jamba-1.5-large-398b", smoke=True).name == "jamba-smoke"
    for arch in ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b"):
        moe = get_config(arch)
        assert moe.family == "moe" and moe.moe.num_experts > 0
        assert build_model(get_config(arch, smoke=True), device="cpu").cfg.family == "moe"


def test_indexer_scores_and_dsa_select_match_jax(jax_model_params):
    """The plain logical-view front half of the DSA block (Eq. 1 + the
    selector) on the carried-over smoke parameters of layer 0."""
    from repro.sparse import dsa as jdsa
    from repro_torch.models.transformer import layer_params
    from repro_torch.sparse import dsa as tdsa
    _, jparams = jax_model_params
    cfg = get_config("llama3.2-1b", smoke=True)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    jidx = jax.tree.map(lambda a: a[0], jparams["layers"]["indexer"])
    tidx = layer_params(tparams["layers"], 0)["indexer"]
    rng = np.random.default_rng(8)
    b, n = 3, 64
    x = rng.normal(size=(b, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(b, n, cfg.dsa.indexer_dim)).astype(np.float32)
    lengths = np.array([64, 30, 9], np.int32)
    prev = rng.integers(0, 9, (b, cfg.dsa.k)).astype(np.int32)
    valid = np.array([True, False, True])
    kw = dict(heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
              rope_base=cfg.rope_base)
    js = jdsa.indexer_scores(jidx, jnp.asarray(x), jnp.asarray(kc),
                             jnp.asarray(lengths - 1), jnp.asarray(lengths), **kw)
    ts = tdsa.indexer_scores(tidx, torch.from_numpy(x), torch.from_numpy(kc),
                             torch.from_numpy(lengths - 1), torch.from_numpy(lengths), **kw)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    sel_kw = dict(k=cfg.dsa.k, min_n=cfg.dsa.min_n, **kw)
    jo = jdsa.dsa_select(jidx, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(prev),
                         jnp.asarray(lengths), prev_valid=jnp.asarray(valid), **sel_kw)
    to = tdsa.dsa_select(tidx, torch.from_numpy(x), torch.from_numpy(kc),
                         torch.from_numpy(prev), torch.from_numpy(lengths),
                         prev_valid=torch.from_numpy(valid), **sel_kw)
    assert to.method == jo.method == "mixed"
    np.testing.assert_array_equal(to.indices.numpy(), np.asarray(jo.indices))
    np.testing.assert_array_equal(to.gvr_rows.numpy(), np.asarray(jo.gvr_rows))


@pytest.mark.parametrize("window", [None, 7])
def test_decode_attention_matches_jax(window):
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(6)
    b, n, kvh, h, d = 2, 32, 2, 4, 16
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, n, kvh, d)).astype(np.float32)
    vc = rng.normal(size=(b, n, kvh, d)).astype(np.float32)
    length = np.array([32, 11], np.int32)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(length), scale=d ** -0.5, window=window)
    got = tlayers.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc), torch.from_numpy(length),
                                   scale=d ** -0.5, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
