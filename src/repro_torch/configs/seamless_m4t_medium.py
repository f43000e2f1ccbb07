"""seamless-m4t-medium [audio]: encoder-decoder, 12L enc + 12L dec,
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206; the speech frontend is a
STUB -- a batch carries precomputed fbank-frame embeddings (``frames``).
[arXiv:2308.11596]

The port trains it (the bidirectional encoder and the decoder's
cross-attention on the plain blockwise path, the decoder's causal
self-attention on the hand-written kernels) and runs its dense-cache
prefill and decode; the serving engine refuses it (``kvcache.supports``).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    num_layers=12,                # decoder
    enc_layers=12,
    vocab_size=256206,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    pattern=("xdec",),
    frontend="audio",
)

REDUCED = CONFIG.scaled(
    name="seamless-reduced", d_model=64, num_layers=2, enc_layers=2,
    vocab_size=512, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
