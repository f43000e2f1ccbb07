"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4),
128 routed experts top-8, expert d_ff=1536, vocab=151936.
[hf:Qwen/Qwen3-235B-A22B]"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    d_model=4096,
    num_layers=94,
    vocab_size=151936,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                    # nominal (all layers are MoE)
    pattern=("attn",),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536, num_shared=0),
    tie_embeddings=False,
)

REDUCED = CONFIG.scaled(
    name="qwen3-moe-reduced", d_model=64, num_layers=4, vocab_size=512,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=64,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, num_shared=0),
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
