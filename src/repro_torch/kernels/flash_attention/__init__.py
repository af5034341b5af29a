"""Causal and/or windowed flash attention: the CUDA kernel
(``csrc/flash_attention.cu``) behind the cache-free self-attention, its
plain PyTorch version (``ref.attention_reference``) and the ops that
choose between them by device (``ops.mha_attention`` in the per-head
layout, ``ops.gqa_flash`` in the model's layout)."""
