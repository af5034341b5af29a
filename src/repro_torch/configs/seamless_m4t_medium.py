"""seamless-m4t-medium: audio encoder-decoder backbone [arXiv:2308.11596].

The speech frontend (mel + conv) is a stub; the encoder consumes
precomputed frame embeddings.
"""
from repro_torch.configs.base import (EncoderConfig, FrontendConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, rope=True,
    encoder=EncoderConfig(n_layers=12, n_heads=16, n_kv_heads=16, d_ff=4096),
    frontend=FrontendConfig(kind="audio", n_tokens=1024, d_embed=1024),
    source="arXiv:2308.11596",
)
