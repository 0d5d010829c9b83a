"""Minimal, dependency-free TensorBoard scalar writer
(``distributed_training_comparison_tpu/utils/tensorboard.py``; it imports
no JAX, and the port keeps its own copy).

Parity: the reference uses ``tensorboardX.SummaryWriter`` for four scalar
groups (lr, loss/step, loss/epoch, acc/epoch — ``src/single/trainer.py:60,159-171``).
This writer emits the TensorBoard wire format directly — TFRecord-framed
``Event`` protobufs, hand-encoded — so training carries no TF or
tensorboardX dependency.  For the same scalars at the same wall time its
bytes are the JAX package's.  One difference: the event file opens for
appending, so a second writer in the same directory, process and second
(a run resumed in place within a second of the first) adds to the file
instead of truncating it; a new file's bytes are the same.

Wire format (both stable, versioned formats):
- record framing: ``len:u64le | masked_crc32c(len) | payload |
  masked_crc32c(payload)`` with mask ``((c>>15 | c<<17) + 0xa282ead8)``;
- ``Event`` proto: wall_time(double,1), step(int64,2),
  file_version(string,3) / summary(Summary,5); ``Summary.Value``: tag(1),
  simple_value(float,2).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

_CRC_TABLE = []


def _crc32c_table() -> list[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF  # int64 two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, *, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    msg = struct.pack("<Bd", (1 << 3) | 1, wall_time)
    msg += bytes([(2 << 3) | 0]) + _varint(step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if summary is not None:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + struct.pack("<Bf", (2 << 3) | 5, value)
    return _field_bytes(1, val)


class SummaryWriter:
    """Drop-in subset of the tensorboardX API: ``add_scalar`` + ``close``."""

    def __init__(self, log_dir: str | Path) -> None:
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.v2"
        )
        self._f = open(self.log_dir / fname, "ab")
        self._write_record(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._write_record(
            _event(time.time(), int(global_step), summary=_scalar_summary(tag, float(value)))
        )
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
