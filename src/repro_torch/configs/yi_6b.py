"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA.  [arXiv:2403.04652]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    d_model=4096,
    num_layers=32,
    vocab_size=64000,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    pattern=("attn",),
)

REDUCED = CONFIG.scaled(
    name="yi-6b-reduced", d_model=64, num_layers=4, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
