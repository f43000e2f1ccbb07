"""internvl2-26b [vlm]: InternLM2-20B-class backbone, 48L d_model=6144 48H
(GQA kv=8) d_ff=16384 vocab=92553; the InternViT frontend is a STUB -- a
batch carries precomputed patch embeddings (``frontend``), placed before
the text.  [arXiv:2404.16821]

The port trains it and runs its dense-cache prefill and decode; the
serving engine refuses it (``kvcache.supports``).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    d_model=6144,
    num_layers=48,
    vocab_size=92553,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    pattern=("attn",),
    frontend="vision",
    frontend_tokens=1024,         # stub ViT patch embeddings per image
)

REDUCED = CONFIG.scaled(
    name="internvl2-reduced", d_model=64, num_layers=4, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, frontend_tokens=8,
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
