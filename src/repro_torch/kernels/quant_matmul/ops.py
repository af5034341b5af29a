"""QTensor-aware matmul over inputs of any rank: the op
``models.layers.linear`` calls when a projection weight is quantized."""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.quant_matmul import kernel as _kernel
from repro_torch.kernels.quant_matmul import ref as _ref


def quant_matmul(x, qt):
    """x: (..., K) activations; qt: QTensor dict of a (K, N) weight
    (``{"q", "scale"}`` int8 or ``{"q4", "scale"}`` int4). Returns (...,
    N) in x's dtype: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. The leading axes are flattened into the kernel's M
    rows; a non-contiguous x is copied first, here, never in the
    kernel."""
    lead, K = x.shape[:-1], x.shape[-1]
    if not x.is_contiguous():
        x = x.contiguous()
    x2 = x.view(-1, K)
    int4 = "q4" in qt
    q = qt["q4"] if int4 else qt["q"]
    scale = qt["scale"]
    if dispatch.use_kernel(x2, q, scale):
        fn = _kernel.quant_matmul_int4_cuda if int4 \
            else _kernel.quant_matmul_int8_cuda
    else:
        fn = _ref.quant_matmul_int4_reference if int4 \
            else _ref.quant_matmul_int8_reference
    y = fn(x2, q, scale)
    return y.view(lead + (q.shape[1],))
