"""Minimal TensorBoard event-file writer (pure Python, no TF/protobuf deps;
the port's copy of ``fpn_mt_image_captioning_tpu/utils/tensorboard.py``).

The reference logs per-epoch ``loss`` and ``CIDEr`` scalars with ``tf.summary``
(the reference's ``train.py:30-33,:60-79``). This module writes real TensorBoard
``events.out.tfevents.*`` files readable by TensorBoard by emitting the protobuf
wire format by hand:

  * TFRecord framing: u64-LE length, masked CRC32C(length), payload, masked
    CRC32C(payload);
  * ``Event`` proto: wall_time (field 1, double), step (field 2, varint),
    file_version (field 3, string) or summary (field 5, message);
  * ``Summary/Value``: tag (field 1, string) + simple_value (field 2, float).

Also provides ``ScalarLogger``, a JSONL sidecar used by the training scripts so
metrics stay greppable without TensorBoard.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time

__all__ = ["SummaryWriter", "ScalarLogger"]

# ---- CRC32C (Castagnoli), table-driven ------------------------------------
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


# ---- protobuf wire helpers -------------------------------------------------
def _varint(n: int) -> bytes:
    if n < 0:
        # protobuf two's-complement: negative int64s are 10-byte varints of
        # 2^64 + n — Python's arithmetic right shift would loop forever
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _pb_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _pb_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _event(wall_time: float, step: int = 0, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    msg = _pb_double(1, wall_time) + _pb_varint(2, step)
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    if summary is not None:
        msg += _pb_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    return _pb_bytes(1, val)


class SummaryWriter:
    """Append-only TensorBoard scalar writer."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, summary=_scalar_summary(tag, value)))

    def close(self) -> None:
        self._f.close()


class ScalarLogger:
    """JSONL metrics sidecar: one {"step", "tag", "value", "ts"} object per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(
            json.dumps({"step": step, "tag": tag, "value": float(value), "ts": time.time()})
            + "\n"
        )
        self._f.flush()

    def close(self) -> None:
        self._f.close()
