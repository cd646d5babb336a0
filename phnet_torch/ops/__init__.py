"""Operations with a CUDA kernel: ``nms`` (lane NMS), ``router_chain``
(the router's residual chain) and ``w8_matmul`` (the weight-only int8
matmul, plain version in ``quant``). Each kernel's module holds its
wrapper and registers the kernel's entries as PyTorch operators in the
``phnet`` namespace (``phnet::nms_keeps``, ``phnet::lane_nms``,
``phnet::router_chain``, ``phnet::w8_matmul``): importing this package
registers them all, as loading an exported program that calls them
needs. ``quant`` holds the int8 quantization and products."""

from . import nms, router_chain, w8_matmul  # noqa: F401  (registers ops)
