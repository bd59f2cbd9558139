"""TensorBoard scalar event files, stdlib only (the port's copy of
``layoutdit_tpu/utils/tensorboard.py``, which writes the same bytes).

Events are hand-encoded protobuf (``tensorflow.Event`` with
``Summary.simple_value``) in TFRecord framing: each record is

  uint64 LE length | uint32 LE masked_crc(length bytes)
  | data | uint32 LE masked_crc(data)

with masked_crc(x) = rotr15(crc32c(x)) + 0xa282ead8 (mod 2^32). The
first event of a file carries file_version "brain.Event:2". The writer
rewrites the whole file at each flush (no append, which object stores
lack), through ``utils/paths.open_path``, so the log directory may be a
``scheme://`` URL; ``read_events`` parses a file back, checking every
CRC.
"""

from __future__ import annotations

import struct
import time

from layoutdit_tpu_torch.utils.paths import open_path

_CRC_TABLE: list[int] = []


def _crc_table() -> list[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, *, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    # tensorflow.Event: 1=wall_time double, 2=step int64,
    # 3=file_version string, 5=summary message
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _len_delim(3, file_version.encode())
    if summary is not None:
        out += _len_delim(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value: 1=tag string, 2=simple_value float; Summary: 1=values
    val = _len_delim(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)
    return _len_delim(1, val)


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


# ------------------------------------------------------------- writer


class TensorBoardWriter:
    """Scalar events held in memory; ``flush()`` rewrites the whole event
    file, ``{logdir}/events.out.tfevents.<unix time>.layoutdit``."""

    def __init__(self, logdir: str):
        self.path = f"{logdir}/events.out.tfevents.{int(time.time())}.layoutdit"
        self._buf = bytearray(_record(_event(time.time(), 0, file_version="brain.Event:2")))
        self._dirty = True

    def scalar(self, tag: str, value: float, step: int,
               wall_time: float | None = None) -> None:
        wt = time.time() if wall_time is None else wall_time
        self._buf += _record(_event(wt, int(step), summary=_scalar_summary(tag, float(value))))
        self._dirty = True

    def scalars(self, values: dict, step: int) -> None:
        """All numeric tags in one Event record (one Summary, many Values)."""
        summary = b""
        for tag, v in values.items():
            try:
                summary += _scalar_summary(tag, float(v))
            except (TypeError, ValueError):
                continue  # non-numeric metric (paths, names)
        if summary:
            self._buf += _record(_event(time.time(), int(step), summary=summary))
            self._dirty = True

    def flush(self) -> None:
        if not self._dirty:
            return
        with open_path(self.path, "wb") as f:
            f.write(bytes(self._buf))
        self._dirty = False

    def close(self) -> None:
        self.flush()


# ------------------------------------------------------------- reader


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(field, wire type, value) of a protobuf message: wire 0 an int,
    1 eight bytes, 2 bytes, 5 four bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} not expected in an event")
        yield field, wire, value


def read_events(path: str) -> list[dict]:
    """The events of a file: ``{"wall_time", "step", "file_version"?,
    "scalars": {tag: value}}`` each. Raises on a bad length or data CRC."""
    with open_path(path, "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if crc != _masked_crc(header):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        body = data[pos + 12:pos + 12 + n]
        (crc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if len(body) != n or crc != _masked_crc(body):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        pos += 16 + n
        event = {"wall_time": 0.0, "step": 0, "scalars": {}}
        for field, _, value in _fields(body):
            if field == 1:
                (event["wall_time"],) = struct.unpack("<d", value)
            elif field == 2:
                event["step"] = value
            elif field == 3:
                event["file_version"] = value.decode()
            elif field == 5:
                for _, _, val in _fields(value):
                    parts = {f: v for f, _, v in _fields(val)}
                    event["scalars"][parts[1].decode()] = struct.unpack("<f", parts[2])[0]
        events.append(event)
    return events
