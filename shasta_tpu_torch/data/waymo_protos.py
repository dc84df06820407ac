"""Minimal dependency-free protobuf wire codec for the Waymo messages; the
port of shasta_tpu/data/waymo_protos.py.

The reference's Waymo chain needs exactly four proto surfaces:
  - metrics_pb2.Objects / Object  (official submission + eval format;
    det3d/datasets/waymo/waymo_common.py:52-174)
  - label_pb2.Label (+ Box / Metadata)  (GT labels and predictions)
  - dataset_pb2.Frame subset  (context/pose/timestamp/laser_labels;
    det3d/datasets/waymo/waymo_decoder.py:22-68)
  - dataset_pb2.Transform     (4x4 veh_to_global, row-major 16 doubles)

The port parses with this codec only, whether or not the waymo-open-dataset
package is installed, so its artifacts do not depend on the installation.
Encode/decode are implemented straight from the protobuf wire spec, with
the public field numbers of the (frozen, proto2) Waymo schemas:
  label.proto:   Box{center_x=1, center_y=2, center_z=3, width=4,
                 length=5, height=6, heading=7} — note length/width field
                 order is swapped relative to declaration order in the
                 official file; Metadata{speed_x=1, speed_y=2, accel_x=3,
                 accel_y=4}; Label{box=1, metadata=2, type=3, id=4,
                 detection_difficulty_level=5, tracking_difficulty_level=6,
                 num_lidar_points_in_box=7}
  metrics.proto: Object{object=1, score=2, overlap_with_nlz=3,
                 context_name=4, frame_timestamp_micros=5};
                 Objects{objects=1}
  dataset.proto: Transform{transform=1}; Stats{time_of_day=2, location=3,
                 weather=4}; Context{name=1, camera_calibrations=2
                 (skipped), laser_calibrations=3, stats=4};
                 Frame{context=1, timestamp_micros=2, pose=3, images=4
                 (skipped), lasers=5, laser_labels=6};
                 RangeImage{range_image=1 (deprecated, skipped),
                 range_image_compressed=2, camera_projection_compressed=3
                 (skipped), range_image_pose_compressed=4}

Decoded messages are attribute-access objects (PB) with proto-style
defaults, so code written against the real *_pb2 API runs unchanged on
either backend.
"""
from __future__ import annotations

import struct
from typing import Any, Iterator

import numpy as np

# ---------------------------------------------------------------------------
# schemas: field_number -> (name, kind[, "repeated"])
# kinds: varint | double | float | string | msg:<Name>
# ---------------------------------------------------------------------------
SCHEMAS: dict[str, dict[int, tuple]] = {
    "Box": {
        1: ("center_x", "double"),
        2: ("center_y", "double"),
        3: ("center_z", "double"),
        4: ("width", "double"),
        5: ("length", "double"),
        6: ("height", "double"),
        7: ("heading", "double"),
    },
    "Metadata": {
        1: ("speed_x", "double"),
        2: ("speed_y", "double"),
        3: ("accel_x", "double"),
        4: ("accel_y", "double"),
    },
    "Label": {
        1: ("box", "msg:Box"),
        2: ("metadata", "msg:Metadata"),
        3: ("type", "varint"),
        4: ("id", "string"),
        5: ("detection_difficulty_level", "varint"),
        6: ("tracking_difficulty_level", "varint"),
        7: ("num_lidar_points_in_box", "varint"),
    },
    "Object": {
        1: ("object", "msg:Label"),
        2: ("score", "float"),
        3: ("overlap_with_nlz", "varint"),
        4: ("context_name", "string"),
        5: ("frame_timestamp_micros", "varint"),
    },
    "Objects": {
        1: ("objects", "msg:Object", "repeated"),
    },
    "Transform": {
        1: ("transform", "double", "repeated"),
    },
    "Stats": {
        2: ("time_of_day", "string"),
        3: ("location", "string"),
        4: ("weather", "string"),
    },
    "Context": {
        # field 2 (repeated CameraCalibration) is intentionally undeclared:
        # the decoder skips unknown fields, and nothing downstream reads it
        1: ("name", "string"),
        4: ("stats", "msg:Stats"),
    },
    "Frame": {
        1: ("context", "msg:Context"),
        2: ("timestamp_micros", "varint"),
        3: ("pose", "msg:Transform"),
        5: ("lasers", "msg:Laser", "repeated"),
        6: ("laser_labels", "msg:Label", "repeated"),
    },
    # range-image surfaces (dataset.proto; used by the raw-pc extraction)
    "MatrixShape": {1: ("dims", "varint", "repeated")},
    "MatrixFloat": {
        1: ("data", "float", "repeated"),
        2: ("shape", "msg:MatrixShape"),
    },
    "RangeImage": {
        # field 1 is the deprecated uncompressed MatrixFloat range_image;
        # field 3 is camera_projection_compressed — both skipped as unknown
        2: ("range_image_compressed", "bytes"),
        4: ("range_image_pose_compressed", "bytes"),
    },
    "Laser": {
        1: ("name", "varint"),
        2: ("ri_return1", "msg:RangeImage"),
        3: ("ri_return2", "msg:RangeImage"),
    },
    "LaserCalibration": {
        1: ("name", "varint"),
        2: ("beam_inclinations", "double", "repeated"),
        3: ("beam_inclination_min", "double"),
        4: ("beam_inclination_max", "double"),
        5: ("extrinsic", "msg:Transform"),
    },
}
SCHEMAS["Context"][3] = ("laser_calibrations", "msg:LaserCalibration", "repeated")

# Waymo Label.Type values (label.proto)
TYPE_UNKNOWN, TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_SIGN, TYPE_CYCLIST = range(5)


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------
def _write_varint(buf: bytearray, v: int) -> None:
    v &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------
def encode(msg_name: str, value: dict[str, Any]) -> bytes:
    """Encode a plain dict (nested dicts for sub-messages, lists for
    repeated fields) as the given message type."""
    schema = SCHEMAS[msg_name]
    by_name = {f[0]: (num, f) for num, f in schema.items()}
    buf = bytearray()
    for name, v in value.items():
        if name not in by_name:
            raise KeyError(f"{msg_name} has no field {name!r}")
        num, f = by_name[name]
        kind = f[1]
        repeated = len(f) > 2
        items = v if repeated else [v]
        for item in items:
            if kind == "varint":
                buf_append_varint(buf, num, item)
            elif kind == "double":
                _write_varint(buf, _tag(num, 1))
                buf += struct.pack("<d", float(item))
            elif kind == "float":
                _write_varint(buf, _tag(num, 5))
                buf += struct.pack("<f", float(item))
            elif kind in ("string", "bytes"):
                raw = item.encode() if isinstance(item, str) else bytes(item)
                _write_varint(buf, _tag(num, 2))
                _write_varint(buf, len(raw))
                buf += raw
            elif kind.startswith("msg:"):
                sub = encode(kind[4:], item)
                _write_varint(buf, _tag(num, 2))
                _write_varint(buf, len(sub))
                buf += sub
            else:  # pragma: no cover
                raise ValueError(kind)
    return bytes(buf)


def buf_append_varint(buf: bytearray, num: int, item) -> None:
    _write_varint(buf, _tag(num, 0))
    _write_varint(buf, int(item))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
class PB:
    """Decoded message with proto-style attribute access + defaults."""

    def __init__(self, msg_name: str, fields: dict[str, Any]):
        self._msg_name = msg_name
        self._fields = fields

    def __getattr__(self, name: str):
        schema = SCHEMAS[self._msg_name]
        for _, f in schema.items():
            if f[0] == name:
                if name in self._fields:
                    return self._fields[name]
                if len(f) > 2:  # repeated default
                    return []
                kind = f[1]
                if kind == "varint":
                    return 0
                if kind in ("double", "float"):
                    return 0.0
                if kind == "string":
                    return ""
                if kind == "bytes":
                    return b""
                return PB(kind[4:], {})  # default sub-message
        raise AttributeError(f"{self._msg_name} has no field {name!r}")

    def __repr__(self):  # pragma: no cover
        return f"PB({self._msg_name}, {self._fields})"


def _iter_fields(data: bytes) -> Iterator[tuple[int, int, Any]]:
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(data, pos)
        elif wire == 1:
            v = data[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = data[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def decode(msg_name: str, data: bytes) -> PB:
    schema = SCHEMAS[msg_name]
    fields: dict[str, Any] = {}
    for num, wire, raw in _iter_fields(data):
        f = schema.get(num)
        if f is None:
            continue  # unknown field: skip (proto forward-compat)
        name, kind = f[0], f[1]
        repeated = len(f) > 2
        if kind == "varint":
            if wire == 2:  # packed repeated varints
                vs, p = [], 0
                while p < len(raw):
                    v, p = _read_varint(raw, p)
                    vs.append(v - (1 << 64) if v >= 1 << 63 else v)
                fields.setdefault(name, []).extend(vs)
                continue
            v = raw if wire == 0 else _read_varint(raw, 0)[0]
            # sign-extend int64 two's complement
            if v >= 1 << 63:
                v -= 1 << 64
        elif kind == "double":
            if wire == 2:  # packed repeated
                v = [struct.unpack("<d", raw[i:i + 8])[0]
                     for i in range(0, len(raw), 8)]
                fields.setdefault(name, []).extend(v)
                continue
            v = struct.unpack("<d", raw)[0]
        elif kind == "float":
            if wire == 2:  # packed repeated floats
                v = [struct.unpack("<f", raw[i:i + 4])[0]
                     for i in range(0, len(raw), 4)]
                fields.setdefault(name, []).extend(v)
                continue
            v = struct.unpack("<f", raw)[0]
        elif kind == "string":
            v = raw.decode(errors="replace")
        elif kind == "bytes":
            v = bytes(raw)
        elif kind.startswith("msg:"):
            v = decode(kind[4:], raw)
        else:  # pragma: no cover
            raise ValueError(kind)
        if repeated:
            fields.setdefault(name, []).append(v)
        else:
            fields[name] = v
    return PB(msg_name, fields)


# ---------------------------------------------------------------------------
# *_pb2-compatible entry points (what data.waymo and data.waymo_decode use)
# ---------------------------------------------------------------------------
def parse_objects(data: bytes) -> PB:
    return decode("Objects", data)


def parse_frame(data: bytes) -> PB:
    return decode("Frame", data)


def encode_objects(objects: list[dict]) -> bytes:
    return encode("Objects", {"objects": objects})


def encode_frame(frame: dict) -> bytes:
    return encode("Frame", frame)


# ---------------------------------------------------------------------------
# MatrixFloat (range images and their poses) without a Python float per value
# ---------------------------------------------------------------------------
def encode_matrix_float(values: np.ndarray) -> bytes:
    """A MatrixFloat of the array's values and shape, its data packed as
    dataset.proto declares it ([packed = true]). `encode` writes repeated
    floats one tag each; `decode` reads both forms."""
    a = np.ascontiguousarray(values, "<f4")
    buf = bytearray()
    _write_varint(buf, _tag(1, 2))
    _write_varint(buf, a.nbytes)
    buf += a.tobytes()
    shape = encode("MatrixShape", {"dims": list(a.shape)})
    _write_varint(buf, _tag(2, 2))
    _write_varint(buf, len(shape))
    buf += shape
    return bytes(buf)


def decode_matrix_float(data: bytes) -> np.ndarray:
    """A MatrixFloat message as a float64 array of its shape: the values of
    decode("MatrixFloat", data).data, reshaped to its dims, read with
    np.frombuffer rather than one struct.unpack per value."""
    chunks, dims = [], []
    for num, wire, raw in _iter_fields(data):
        if num == 1:  # wire 2: a packed run; wire 5: one value
            chunks.append(np.frombuffer(raw, "<f4"))
        elif num == 2:
            dims = decode("MatrixShape", raw).dims
    values = np.concatenate(chunks) if chunks else np.zeros(0, "<f4")
    return values.astype(np.float64).reshape(list(dims))
