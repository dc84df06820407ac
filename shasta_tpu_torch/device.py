"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit CPU request they raise: the port never carries on
quietly on the CPU.

A plain copy from host memory to the card (torch.tensor(..., device=
"cuda"), .to("cuda")) waits for the card to finish the work queued before
it, so a step that makes such copies cannot run ahead of the card.
`const` makes each small constant once per device and `upload` copies
through pinned memory without that wait.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _frozen(values):
    """A hashable key of the values; the dtype kind keeps 1 and 1.0 apart."""
    a = np.asarray(values)
    return (a.dtype.kind, a.shape, tuple(a.reshape(-1).tolist()))


@functools.cache
def _const(frozen, dtype, device: torch.device) -> torch.Tensor:
    _, shape, flat = frozen
    return torch.tensor(flat, dtype=dtype, device=device).reshape(shape)


def const(values, device, dtype=None) -> torch.Tensor:
    """A small constant tensor (nested sequence or numpy array) on
    `device`, made once per (values, dtype, device) and shared: callers
    must not write to it. Its dtype is torch.tensor's choice unless given."""
    return _const(_frozen(values), dtype, torch.device(device))


def upload(values, device) -> torch.Tensor:
    """A host array or tensor on `device`; to a card through pinned memory
    and a non-blocking copy, which does not wait for the card."""
    t = torch.as_tensor(values)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
