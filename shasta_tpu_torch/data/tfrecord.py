"""Dependency-free TFRecord framing reader/writer; the port of
shasta_tpu/data/tfrecord.py.

The reference's Waymo extraction iterates TFRecords through TensorFlow
(tf.data.TFRecordDataset, e.g. preprocessing/waymo_data/testset/
time_stamp.py:37-42). All the extraction needs from it is the record
framing, a tiny fixed format; per record:

    uint64  length           (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   payload[length]
    uint32  masked_crc32c(payload)

crc32c is the Castagnoli CRC; the mask is rot-right-15 plus a constant.
The CRC is the port's C++ runtime's (runtime/src/host_ops.cpp, built at
first use); where the runtime cannot be built it raises, as every entry
point of the runtime does. `_crc32c_py` is its plain version, kept for the
tests. Verification on read is optional (off by default: corrupt records
still fail proto parsing).
"""
from __future__ import annotations

import functools
import os
import struct
from typing import Iterator

from .. import runtime

_POLY = 0x82F63B78
_MASK_DELTA = 0xA282EAD8


@functools.cache
def _table() -> tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        table.append(c)
    return tuple(table)


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """The plain version of crc32c: a table loop in Python."""
    t = _table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """Castagnoli CRC through the port's runtime."""
    return runtime.crc32c(bytes(data), crc)


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while f.tell() < size:
            hdr = f.read(12)
            if len(hdr) < 12:
                raise IOError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", hdr[:8])
            if verify_crc:
                (crc_len,) = struct.unpack("<I", hdr[8:12])
                if masked_crc(hdr[:8]) != crc_len:
                    raise IOError(f"length CRC mismatch in {path}")
            payload = f.read(length)
            if len(payload) < length:
                raise IOError(f"truncated TFRecord payload in {path}")
            tail = f.read(4)
            if verify_crc:
                (crc_data,) = struct.unpack("<I", tail)
                if masked_crc(payload) != crc_data:
                    raise IOError(f"payload CRC mismatch in {path}")
            yield payload


def write_tfrecord(path: str, payloads) -> None:
    """Write payload byte strings with correct framing + CRCs."""
    with open(path, "wb") as f:
        for p in payloads:
            hdr = struct.pack("<Q", len(p))
            f.write(hdr)
            f.write(struct.pack("<I", masked_crc(hdr)))
            f.write(p)
            f.write(struct.pack("<I", masked_crc(p)))
