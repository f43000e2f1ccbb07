"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA.
[hf:openbmb/MiniCPM3-4B]"""
from repro_torch.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    d_model=2560,
    num_layers=62,
    vocab_size=73448,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    pattern=("mla",),
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
)

REDUCED = CONFIG.scaled(
    name="minicpm3-reduced", d_model=64, num_layers=4, vocab_size=512,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
