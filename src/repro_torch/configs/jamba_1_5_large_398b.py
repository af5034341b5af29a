"""jamba-1.5-large-398b: hybrid Mamba+attention 1:7 interleave with MoE
16e top-2 every other layer [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, rope=False,  # Jamba uses no positional encoding
    attn_every=8,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, moe_every=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128,
                  n_groups=1, chunk=256),
    source="arXiv:2403.19887",
)
