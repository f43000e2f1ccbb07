"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280.  [arXiv:2405.21060]"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    d_model=2560,
    num_layers=64,
    vocab_size=50280,
    d_ff=0,                       # Mamba-2 blocks replace attn+FFN
    pattern=("ssd",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True,           # O(1)-state decode
)

REDUCED = CONFIG.scaled(
    name="mamba2-reduced", d_model=64, num_layers=4, vocab_size=512,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
    dtype="float32", attn_q_block=64, attn_kv_block=64,
)


def get_config() -> ModelConfig:
    return CONFIG
