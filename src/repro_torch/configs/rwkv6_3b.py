"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536 [arXiv:2404.05892].
DSA/GVR INAPPLICABLE (attention-free: no KV cache, no Top-K selection) —
built without the technique per DESIGN §Arch-applicability. long_500k runs
(O(1) recurrent state).
"""
from repro_torch.models.config import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=8960, vocab=65536, rwkv_head_dim=64,
    dsa=DSAConfig(enabled=False),
)

SMOKE = ModelConfig(
    name="rwkv6-3b-smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=256, vocab=512, rwkv_head_dim=64,
    dsa=DSAConfig(enabled=False), dtype="float32",
)
