"""Operations with a CUDA kernel: ``nms`` (lane NMS), ``router_chain``
(the router's residual chain) and ``w8_matmul`` (the weight-only int8
matmul, plain version in ``quant``). Each kernel's module holds its
wrapper; ``quant`` holds the int8 quantization and products."""
