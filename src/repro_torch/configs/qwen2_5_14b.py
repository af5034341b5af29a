"""qwen2.5-14b: dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, rope=True, qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)
