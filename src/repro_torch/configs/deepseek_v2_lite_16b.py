"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512,
2 shared + 64 routed experts top-6, expert d_ff=1408, vocab=102400.
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]

The assignment line says "MoE 64e top-6" with a note "2 shared+160 routed";
we follow the primary spec + the HF config: 64 routed + 2 shared, top-6.
Layer 0 uses a dense FFN (d_ff=10944) per the HF config.
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    d_model=2048,
    num_layers=27,
    vocab_size=102400,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                   # dense FFN for layer 0
    pattern=("mla",),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
    moe_skip_first=1,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=None,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
)

REDUCED = CONFIG.scaled(
    name="deepseek-v2-lite-reduced", d_model=64, num_layers=3, vocab_size=512,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, num_shared=1),
    moe_skip_first=1,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=None,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
