"""PyTorch + CUDA port of the JAX package `shasta_tpu`.

The JAX package `shasta_tpu` is the reference; this package mirrors its
module paths so each counterpart is easy to find. It imports torch and
numpy only. Entry points take a `device` and run on "cuda" unless the
caller passes device="cpu"; on the CPU every hand-written kernel runs its
plain PyTorch version (ops/kernels/).
"""
from .device import resolve_device  # noqa: F401


def __getattr__(name):
    # the lazy top-level API of shasta_tpu (keeps `import shasta_tpu_torch` light)
    if name in ("ShastaModel", "ShastaConfig"):
        from . import models

        return getattr(models, name)
    if name in ("ScenePipeline", "BatchedScenePipeline", "MultiClassScenePipeline"):
        from . import infer

        return getattr(infer, name)
    if name == "register_all":
        from .registry_setup import register_all

        return register_all
    raise AttributeError(name)
