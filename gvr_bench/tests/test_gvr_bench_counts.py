"""The bytes and operations of gvr_bench/counts against PERF.md's kernel
table (B=4, N=8192, K=2048, H_i 64, d_i 128, page 64, the kernel phase's
lengths) and against the configurations' sizes."""


import pytest

from gvr_bench.counts import h100, kernels, step
from gvr_bench.harness import spec

LENGTHS = [8192, 5000, 1000, 3001]


def test_b1_bound_is_the_kernel_tables():
    nb, fl = kernels.b1([8192] * 4, m=2048, k=2048)
    assert round(h100.bound_s(nb, fl) * 1e3, 7) == 0.0000685


def test_b2_bound_is_the_kernel_tables():
    nb, fl = kernels.b2(LENGTHS, heads=64, dim=128, page_size=64, k=2048)
    # the table's 4,589,968 B read all 128 table entries a row; only the
    # 270 entries of the rows' pages are needed
    assert nb == 4_589_968 - (4 * 128 - 270) * 4
    assert round(h100.bound_s(nb, fl) * 1e3, 5) == 0.00137


def test_b2_scoring_is_b2_less_b1_io_plus_the_score_row():
    s_b, s_f = kernels.b2_scoring(LENGTHS, heads=64, dim=128, page_size=64)
    b_b, b_f = kernels.b2(LENGTHS, heads=64, dim=128, page_size=64, k=2048)
    assert s_f == b_f == 2 * 64 * 128 * sum(LENGTHS)
    assert s_b == b_b - 4 * 2048 * (4 + 8) - 4 * 32 + sum(LENGTHS) * 4


@pytest.mark.parametrize("kind", ["b1", "b2_scoring"])
def test_a_padded_row_counts_its_real_length_only(kind):
    """Rows of 5000 and 1000 positions in a pool 131072 wide: the bytes
    grow with the lengths and not with the width, by 4 B a score (and by
    a key and its page's table entry a page, for the scoring)."""
    def count(lengths):
        if kind == "b1":
            return kernels.b1(lengths, m=2048, k=2048)[0]
        return kernels.b2_scoring(lengths, heads=64, dim=128, page_size=64)[0]
    short, longer = count([5000, 1000]), count([5064, 1000])
    per_pos = 4 if kind == "b1" else 4 + 128 * 2
    assert longer - short == 64 * per_pos + (0 if kind == "b1" else 4)
    if kind == "b1":         # 4 B a real score, not 4 B a pool position
        assert short == 6000 * 4 + 2 * (2048 * 4 + 2048 * 8 + 32)


def test_a_tick_reads_every_weight_once():
    conf = spec.config("chatglm3-6b")
    nb, _ = step.tick(conf["model"], [], dsa_on=True)
    # no rows: every weight but the embedding, once
    params = conf["sizes"]["parameters"]
    embed = conf["model"]["vocab"] * conf["model"]["d_model"]
    assert nb == pytest.approx((params - embed) * 2, rel=1e-3)


def test_per_token_cache_bytes_match_the_files():
    conf = spec.config("chatglm3-6b")
    m = conf["model"]
    per = m["n_layers"] * (2 * m["n_kv_heads"] * m["head_dim"] * 2
                           + m["dsa"]["indexer_dim"] * 2)
    assert per == conf["sizes"]["cache_bytes_per_token"] == 35840


def test_workload_memory_is_the_pools_and_the_weights():
    w = spec.workload("chatglm3-6b.docs-128k")["memory"]
    assert w["pool_bytes"] == 16385 * 64 * 35840
    assert (w["pool_bytes"] + w["weight_bytes"]) / 1e9 == pytest.approx(52.0, abs=0.1)
