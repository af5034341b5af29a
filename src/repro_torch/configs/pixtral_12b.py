"""pixtral-12b: ViT frontend stub + mistral-nemo-class decoder
[hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, rope=True, head_dim=160,
    frontend=FrontendConfig(kind="vision", n_tokens=1024, d_embed=1024),
    source="hf:mistralai/Pixtral-12B-2409",
)
