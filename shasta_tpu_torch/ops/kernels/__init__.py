"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

A kernel is a ctypes launch: its output has no grad_fn, so autograd would
stop at it without a word. Each wrapper therefore refuses an input that
requires grad while grad mode is on (`refuse_autograd`), on every device:
on the CPU the plain version stands in for the kernel and keeps its
contract. A caller that needs gradients calls the plain version itself.
"""
import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when grad mode is on and one of `tensors` (None allowed)
    requires grad: the kernel `name` has no backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad. Call it under "
            f"torch.no_grad(), or call {name}_plain, which autograd differentiates")
