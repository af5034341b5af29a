"""Stretch architectures beyond the assigned ten (same public pool).

These exercise the existing family machinery with different regimes:
mixtral-8x7b (few large experts vs qwen2-moe's many small) and a
gemma2-9b-class dense model (global sliding window — every layer SWA).
Selectable via ``get_arch`` but kept out of ``ARCHS``, as in the JAX
package, whose registry lists the assigned ten.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

EXTRA_ARCHS = {
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, rope=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
        source="arXiv:2401.04088",
    ),
    "gemma2-9b-class": ModelConfig(
        name="gemma2-9b-class", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
        d_ff=14336, vocab=256128, rope=True, head_dim=256,
        sliding_window=4096,   # windowed attention as the default regime
        tie_embeddings=True,
        source="arXiv:2408.00118",
    ),
}
