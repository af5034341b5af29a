"""granite-moe-3b-a800m: 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, rope=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
