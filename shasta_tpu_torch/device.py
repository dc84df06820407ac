"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit CPU request they raise: the port never carries on
quietly on the CPU.
"""
from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Keep f32 products in full f32. cuDNN convolutions default to TF32
    (about three decimal digits), which breaks the 1e-4 parity against the
    JAX reference; the fast mode of the port is the explicit bf16 trunk."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`device` None means "cuda". Raises when CUDA is asked for (or
    defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path")
        disable_tf32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
