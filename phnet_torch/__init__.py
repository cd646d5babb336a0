"""phnet_torch: PHNet online video lane detection in PyTorch for an NVIDIA
H100, a port of the JAX package ``phnet_tpu`` (the reference it is tested
against). Lane NMS, the router's residual chain and the weight-only int8
matmul of the quantized generator chains run as hand-written CUDA kernels
(``csrc/``); every other operation is plain PyTorch.
Entry points run on the card unless given ``device="cpu"``."""
