"""Flash attention in the two layouts the JAX package's ops take: the
per-head layout (``mha_attention``, q (B, Hq, L, hd), k/v (B, Hkv, L,
hd)) and the model's (``gqa_flash``, (B, L, H, hd)). CUDA tensors go to
the kernel, which reads the model's layout through strides (no
transposed copy); CPU tensors go to the plain version, GQA heads
expanded first as the JAX op does."""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def mha_attention(q, k, v, *, causal=True, window=0):
    """q (B, Hq, Lq, hd); k, v (B, Hkv, Lk, hd), G = Hq / Hkv from the
    shapes. Returns (B, Hq, Lq, hd) in q's dtype."""
    if dispatch.use_kernel(q, k, v):
        out = _kernel.flash_attention_cuda(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window)
        return out.transpose(1, 2)
    G = q.shape[1] // k.shape[1]
    if G != 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    return _ref.attention_reference(q, k, v, causal=causal, window=window)


def gqa_flash(q, k, v, *, causal=True, window=0):
    """q (B, Lq, Hq, hd); k, v (B, Lk, Hkv, hd), the model's layout.
    Returns (B, Lq, Hq, hd) in q's dtype."""
    if dispatch.use_kernel(q, k, v):
        return _kernel.flash_attention_cuda(q, k, v, causal=causal,
                                            window=window)
    out = mha_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)
