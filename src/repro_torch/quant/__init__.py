"""Post-training weight quantization for the edge deployment profile.

* ``qtensor``: the quantized-weight leaf format (symmetric per-channel
  int8, group-wise packed int4) with pack/unpack and quantize/dequantize.
* ``params``: whole-tree quantization, its inverse and byte accounting.

Quantized projections route through ``kernels/quant_matmul`` via
``models.layers.linear``; the int8 KV cache lives in
``models.layers.make_kv_cache(quant=True)`` and is switched on from
serving with ``Engine(kv_cache_dtype="int8")`` or the ``edge`` variant.
"""
from repro_torch.quant.params import (dequantize_params, quantize_for_cfg,
                                      quantize_params, quantized_shapes,
                                      quantized_stats)
from repro_torch.quant.qtensor import (QTENSOR_KEYS, dequantize_tensor,
                                       is_qtensor, pack_int4, qtensor_bits,
                                       qtensor_nbytes, quantize_tensor,
                                       unpack_int4)

__all__ = [
    "QTENSOR_KEYS", "dequantize_tensor", "is_qtensor", "pack_int4",
    "qtensor_bits", "qtensor_nbytes", "quantize_tensor", "unpack_int4",
    "dequantize_params", "quantize_for_cfg", "quantize_params",
    "quantized_shapes", "quantized_stats",
]
