"""TensorBoard event files without TensorBoard: the writer the JAX trainer
gets from tensorboardX (``SummaryWriter.add_scalar`` / ``add_image``), and a
reader of the same framing.

A file ``events.out.tfevents.<secs>.<host>`` is a sequence of TFRecords,
each ``u64 length | masked CRC32C of the length | data | masked CRC32C of
the data`` (little-endian), whose data is one serialized ``Event`` protobuf.
The first record carries ``file_version: "brain.Event:2"``; each later one a
``Summary`` with one value: a ``simple_value`` (scalars) or an ``Image``
(height, width, colorspace, PNG bytes). The few protobuf fields this needs
are encoded by hand, PNG with ``zlib`` and ``struct``, and CRC32C
(Castagnoli) is a table-driven function here: the card's machine has no
tensorboardX and no promised protobuf runtime, so this module imports
neither. TensorBoard's own event loader reads the files
(``tests/test_torch_events.py``).
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Dict, Iterator, List

import numpy as np

FILE_VERSION = "brain.Event:2"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15, add 0xA282EAD8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire format ---------------------------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement
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
    return _varint(field << 3 | wire)


def _len_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(wall_time: float, step: int, file_version: str = None,
           summary: bytes = None) -> bytes:
    """``Event``: wall_time 1 (double), step 2 (int64), file_version 3,
    summary 5."""
    msg = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        msg += _key(2, 0) + _varint(int(step))
    if file_version is not None:
        msg += _len_field(3, file_version.encode())
    if summary is not None:
        msg += _len_field(5, summary)
    return msg


def _summary_value(tag: str, simple_value: float = None,
                   image: bytes = None) -> bytes:
    """``Summary`` holding one ``Summary.Value``: tag 1, simple_value 2
    (float), image 4."""
    value = _len_field(1, tag.encode())
    if simple_value is not None:
        value += _key(2, 5) + struct.pack("<f", simple_value)
    if image is not None:
        value += _len_field(4, image)
    return _len_field(1, value)


def _image(height: int, width: int, colorspace: int, png: bytes) -> bytes:
    """``Summary.Image``: height 1, width 2, colorspace 3, encoded 4."""
    return (_key(1, 0) + _varint(height) + _key(2, 0) + _varint(width)
            + _key(3, 0) + _varint(colorspace) + _len_field(4, png))


def encode_png(img: np.ndarray) -> bytes:
    """PNG of an ``(H, W, C)`` uint8 array, C in {1, 3, 4}: 8 bits per
    sample, filter 0 on every row, one zlib stream."""
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img, np.uint8).reshape(
                               h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


class EventWriter:
    """Appends TensorBoard events to a new file in ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}")
        self._file = open(self.path, "ab")
        self._record(_event(now, 0, file_version=FILE_VERSION))

    def _record(self, data: bytes) -> None:
        length = struct.pack("<Q", len(data))
        self._file.write(length + struct.pack("<I", masked_crc32c(length))
                         + data + struct.pack("<I", masked_crc32c(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), step, summary=_summary_value(
            tag, simple_value=float(value))))

    def add_image(self, tag: str, img: np.ndarray, step: int,
                  dataformats: str = "HWC") -> None:
        """An ``(H, W, C)`` uint8 image, C in {1, 3, 4} (what
        ``train/images.py`` writes)."""
        img = np.asarray(img)
        if dataformats != "HWC" or img.dtype != np.uint8 or img.ndim != 3:
            raise ValueError(f"add_image takes an (H, W, C) uint8 array, got "
                             f"{img.dtype} {img.shape} as {dataformats}")
        h, w, c = img.shape
        image = _image(h, w, c, encode_png(img))
        self._record(_event(time.time(), step,
                            summary=_summary_value(tag, image=image)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


# --- reading ----------------------------------------------------------------

def _read_varint(buf: bytes, i: int):
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def _fields(buf: bytes) -> Dict[int, list]:
    """``{field: [values]}`` of a serialized message: ints for varints,
    bytes for the other wire types."""
    out: Dict[int, list] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        wire = key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, i = buf[i:i + n], i + n
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.setdefault(key >> 3, []).append(value)
    return out


def read_records(path: str) -> Iterator[bytes]:
    """The data of each TFRecord in ``path``; raises on a bad CRC or a
    truncated record."""
    with open(path, "rb") as f:
        blob = f.read()
    i = 0
    while i < len(blob):
        if i + 12 > len(blob):
            raise ValueError(f"{path}: truncated record header at {i}")
        length = blob[i:i + 8]
        (n,) = struct.unpack("<Q", length)
        (crc,) = struct.unpack("<I", blob[i + 8:i + 12])
        if crc != masked_crc32c(length):
            raise ValueError(f"{path}: bad length CRC at {i}")
        data = blob[i + 12:i + 12 + n]
        end = i + 12 + n + 4
        if end > len(blob):
            raise ValueError(f"{path}: truncated record at {i}")
        (crc,) = struct.unpack("<I", blob[end - 4:end])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: bad data CRC at {i}")
        yield data
        i = end


def read_events(path: str) -> List[dict]:
    """Every event of a file as ``{"wall_time", "step", "file_version"?,
    "values": [{"tag", "simple_value"? , "image"?: {"height", "width",
    "colorspace", "encoded"}}]}``."""
    events = []
    for data in read_records(path):
        f = _fields(data)
        event = {"wall_time": struct.unpack("<d", f[1][0])[0],
                 "step": f.get(2, [0])[0], "values": []}
        if 3 in f:
            event["file_version"] = f[3][0].decode()
        for summary in f.get(5, []):
            for raw in _fields(summary).get(1, []):
                v = _fields(raw)
                value = {"tag": v[1][0].decode()}
                if 2 in v:
                    value["simple_value"] = struct.unpack("<f", v[2][0])[0]
                if 4 in v:
                    im = _fields(v[4][0])
                    value["image"] = {"height": im[1][0], "width": im[2][0],
                                      "colorspace": im[3][0],
                                      "encoded": im[4][0]}
                event["values"].append(value)
        events.append(event)
    return events


def event_files(log_dir: str) -> List[str]:
    """The event files directly in ``log_dir``, oldest name first."""
    return sorted(os.path.join(log_dir, n) for n in os.listdir(log_dir)
                  if n.startswith("events.out.tfevents."))
