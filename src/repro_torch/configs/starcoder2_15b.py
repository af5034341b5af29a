"""starcoder2-15b: dense GQA + RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, rope=True,
    source="arXiv:2402.19173",
)
