"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch.  [arXiv:2401.02954]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    d_model=8192,
    num_layers=95,
    vocab_size=102400,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    pattern=("attn",),
    tie_embeddings=False,
)

REDUCED = CONFIG.scaled(
    name="deepseek-67b-reduced", d_model=64, num_layers=4, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
