"""Device resolution and float32 numerics shared by the port's entry
points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card (``"cuda"``). A CUDA device without a card
    raises: the CPU, where every kernel runs its plain PyTorch version,
    is only used when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "phnet_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev


@contextlib.contextmanager
def full_f32():
    """Run the body with TF32 off for cuBLAS matmuls and cuDNN
    convolutions, and give the caller's settings back on the way out,
    exceptions included. torch turns TF32 on for cuDNN by default; the
    port computes in float32.

    Only the legacy flags are read and written
    (``torch.get/set_float32_matmul_precision``,
    ``torch.backends.cudnn.allow_tf32``): their setters keep torch's
    newer ``fp32_precision`` settings in step, so the two never disagree
    (a disagreement makes torch raise). ``cudnn.flags(...)`` is not used:
    it resets every flag it is not given, the newer precision included.
    cuDNN's ``enabled``, ``benchmark`` and ``deterministic`` are left
    alone. Usable as a decorator."""
    cudnn = torch.backends.cudnn
    matmul, conv = torch.get_float32_matmul_precision(), cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        cudnn.allow_tf32 = conv
