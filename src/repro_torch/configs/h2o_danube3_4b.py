"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 [arXiv:2401.16818].
SWA window 4096 (mistral-style). DSA Top-K decode restricted to the window
(selector masks out-of-window scores — DESIGN §Arch-applicability).
"""
from repro_torch.models.config import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab=32000, head_dim=120,
    swa_window=4096, dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="h2o-danube-3-4b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
    swa_window=64,
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
