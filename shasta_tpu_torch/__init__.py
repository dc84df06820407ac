"""PyTorch + CUDA port of the single-class ShaSTA serving step.

The JAX package `shasta_tpu` is the reference; this package mirrors its
module paths so each counterpart is easy to find. It imports torch and
numpy only. Entry points take a `device` and run on "cuda" unless the
caller passes device="cpu"; on the CPU every hand-written kernel runs its
plain PyTorch version (ops/kernels/).
"""
from .device import resolve_device  # noqa: F401
