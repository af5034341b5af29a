"""mamba2-780m: attention-free SSD [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, rope=False, head_dim=1,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    source="arXiv:2405.21060",
)
