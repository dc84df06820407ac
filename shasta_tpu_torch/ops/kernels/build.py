"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into its own shared
library with a plain C interface, loaded with ctypes. Builds run at first
use, all sources at once (one nvcc process each), into
`shasta_tpu_torch/_build/`; a library's file name carries a hash of its
sources, so an edited source builds anew. A failed build raises.

    python -m shasta_tpu_torch.ops.kernels.build   # build all, print ptxas info
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("block_conv", "window_conv", "lookup", "gather_conv", "block_extract")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel.
    Returns {name: (seconds, ptxas report)} for the sources it built."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return report


def build_variant(name: str, tag: str, edit: tuple | None = None,
                  src: Path = CSRC) -> ctypes.CDLL:
    """<name>.cu built from a copy of `src` (csrc, or another checkout's,
    such as a redesign's parent) under _build/variants/<tag>/ with `edit` =
    (file, old text, new text) applied (the old text must occur once), and
    loaded: a design the probes time beside the shipped one."""
    d = BUILD / "variants" / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    if edit:
        fname, old, new = edit
        src = (d / fname).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"variant {tag}: {old!r} does not occur once in {fname}")
        (d / fname).write_text(src.replace(old, new))
    out = d / f"{name}.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(d / f"{name}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"variant {tag} failed to build:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    build_all()
    return ctypes.CDLL(str(_lib_path(name)))


if __name__ == "__main__":
    for n, (sec, log) in build_all().items():
        print(f"{n}: built in {sec:.1f} s\n{log}")
