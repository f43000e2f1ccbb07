"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global attention, 1024-token sliding window.
[hf:google/gemma-3-4b-pt]

The port trains and serves it: its dense-cache decode keeps each
sliding-window layer's cache in a ring buffer of ``window`` slots (only
the 1/6 global layers hold the full KV); the serving engine pages every
layer's cache and masks the window.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    d_model=2560,
    num_layers=34,                # 5 superblocks of (5 local + 1 global) + 4 local
    vocab_size=262144,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    sub_quadratic=True,
)

REDUCED = CONFIG.scaled(
    name="gemma3-reduced", d_model=64, num_layers=8, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, window=32,
    pattern=("local", "local", "local", "attn"),
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
