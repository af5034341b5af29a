"""internlm2-20b: dense GQA decoder [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544, rope=True,
    sliding_window=0,  # long_500k uses the swa variant (see variants)
    source="arXiv:2403.17297",
)
