"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, Griffin pattern (RG-LRU, RG-LRU, local-attn) with a
2048-token window.  [arXiv:2402.19427]"""
from repro_torch.config import LRUConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    d_model=2560,
    num_layers=26,                # 8 x (rglru, rglru, local) + 2 rglru
    vocab_size=256000,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    lru=LRUConfig(lru_width=2560, d_conv=4, block_width=256),
    sub_quadratic=True,           # O(1)-state + windowed attn: long_500k runs
)

REDUCED = CONFIG.scaled(
    name="recurrentgemma-reduced", d_model=64, num_layers=6, vocab_size=512,
    num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128, window=32,
    lru=LRUConfig(lru_width=64, d_conv=4, block_width=16),
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
