"""Native host runtime: C++ geometry, NMS and voxelizer through ctypes, the
port of shasta_tpu/runtime/__init__.py.

`src/host_ops.cpp` is the port's own copy of the JAX package's source, byte
for byte. It compiles with g++ at first use into shasta_tpu_torch/_build/;
the library's file name carries a hash of the source, so an edited source
builds anew. The build runs under a lock file that holds across processes
(fcntl.flock) and writes a temporary file that `os.replace` moves into
place, so parallel processes never load a half-written library.

There is no numpy fallback: where the library cannot be built, every entry
point raises with the compiler's message. (The numpy voxelizer
`ops.voxelize.points_to_voxel_np` stays as the tests' reference.)
`plan_group` and `strided_out_keys` serve the JAX PosWord planner, which
the port does not use; they are not bound.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "host_ops.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _lib_path() -> Path:
    return BUILD / f"libshasta_host-{hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, compiled first if it is missing. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "libshasta_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            r = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                               capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: {SRC.name} cannot be built") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.boxes_iou_bev.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p]
    lib.boxes_iou_3d.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p]
    lib.rotate_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float, i64p]
    lib.rotate_nms.restype = ctypes.c_int
    lib.pc_in_box.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float, u8p]
    lib.points_to_voxel.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, f32p,
        ctypes.c_int, ctypes.c_int, f32p, i32p, i32p,
    ]
    lib.points_to_voxel.restype = ctypes.c_int
    lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
    lib.crc32c.restype = ctypes.c_uint32
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def iou_bev(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise rotated BEV IoU; geometry rows [x,y,z,w,l,h,yaw]."""
    b1 = np.ascontiguousarray(boxes1, np.float32)
    b2 = np.ascontiguousarray(boxes2, np.float32)
    out = np.empty((len(b1), len(b2)), np.float32)
    _lib().boxes_iou_bev(b1, len(b1), b2, len(b2), out)
    return out


def iou_3d(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    b1 = np.ascontiguousarray(boxes1, np.float32)
    b2 = np.ascontiguousarray(boxes2, np.float32)
    out = np.empty((len(b1), len(b2)), np.float32)
    _lib().boxes_iou_3d(b1, len(b1), b2, len(b2), out)
    return out


def rotate_nms(boxes7: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Indices of the kept boxes, in descending score order."""
    b = np.ascontiguousarray(boxes7, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    keep = np.empty(len(b), np.int64)
    k = _lib().rotate_nms(b, s, len(b), iou_threshold, keep)
    return keep[:k]


def pc_in_box(box_mot: np.ndarray, pc: np.ndarray, scale: float = 1.5) -> np.ndarray:
    """mot-layout box [x,y,z,o,l,w,h]; pc (P, >=3). Returns a bool mask."""
    b = np.ascontiguousarray(box_mot[:7], np.float32)
    p = np.ascontiguousarray(pc[:, :3], np.float32)
    mask = np.empty(len(p), np.uint8)
    _lib().pc_in_box(b, p, len(p), scale, mask)
    return mask.astype(bool)


def crc32c(data: bytes, crc: int = 0) -> int:
    """Castagnoli CRC (TFRecord framing)."""
    return int(_lib().crc32c(data, len(data), crc))


def points_to_voxel(points: np.ndarray, voxel_size, coors_range,
                    max_points: int = 10, max_voxels: int = 120000):
    """The host voxelizer: (voxels (M, P, C), coords zyx (M, 3) int32,
    num_points (M,)), byte-identical to ops.voxelize.points_to_voxel_np."""
    lib = _lib()
    p = np.ascontiguousarray(points, np.float32)
    n, c = p.shape
    vs = np.asarray(voxel_size, np.float32)
    cr = np.asarray(coors_range, np.float32)
    voxels = np.zeros((max_voxels, max_points, c), np.float32)
    coors = np.zeros((max_voxels, 3), np.int32)
    nump = np.zeros((max_voxels,), np.int32)
    m = lib.points_to_voxel(p, n, c, vs, cr, max_points, max_voxels, voxels, coors, nump)
    return voxels[:m], coors[:m], nump[:m]
