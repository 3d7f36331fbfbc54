"""Minimal TensorBoard event-file writer, pure Python with no TF (the
port's own copy of ground_plane_polling_tpu/utils/tensorboard.py, which
imports no JAX).

Training keeps JSONL as the source of truth (training/loop.py) and mirrors
each epoch's scalars into standard `events.out.tfevents.*` files, so
existing TensorBoard tooling reads them (the Keras reference logged
through its TensorBoard callback).

The event-file format is a TFRecord stream of serialized Event protos:

    record  := len:uint64le  crc32c(len)^mask:uint32le
               payload[len]  crc32c(payload)^mask:uint32le
    Event   := 1: wall_time (double)   2: step (int64)
               3: file_version (string, first record only)
               5: Summary { repeated Value { 1: tag  2: simple_value } }

Both the proto encoding and the masked-CRC32C framing are small enough to
write directly.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

_FILE_COUNTER = 0
_COUNTER_LOCK = threading.Lock()

__all__ = ["TensorBoardWriter", "jsonl_to_tensorboard"]

# --- CRC32C (Castagnoli), table-driven ------------------------------------

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
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- minimal protobuf wire encoding ----------------------------------------

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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    summary_value = _bytes(1, tag.encode()) + _float(2, float(value))
    summary = _bytes(1, summary_value)
    return _double(1, wall_time) + _int64(2, int(step)) + _bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _bytes(3, b"brain.Event:2")


class TensorBoardWriter:
    """Append-only scalar writer producing TensorBoard-loadable event files."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        # pid + counter suffix (like TF's writer): two writers opened in
        # the same second on one host must not append to the same file —
        # interleaved TFRecord writes corrupt it for TensorBoard
        global _FILE_COUNTER
        with _COUNTER_LOCK:
            _FILE_COUNTER += 1
            counter = _FILE_COUNTER
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.{counter}")
        self._f = open(os.path.join(logdir, name), "ab")
        self._write(_version_event(time.time()))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float = None):
        self._write(_scalar_event(
            tag, value, step,
            time.time() if wall_time is None else wall_time))

    def add_scalars(self, scalars: dict, step: int):
        for tag, value in scalars.items():
            try:
                self.add_scalar(tag, float(value), step)
            except (TypeError, ValueError):
                pass  # non-numeric record fields (paths, messages)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def jsonl_to_tensorboard(jsonl_path: str, logdir: str,
                         step_key: str = "epoch") -> int:
    """Convert a training JSONL log into TB events; returns #records."""
    import json

    writer = TensorBoardWriter(logdir)
    n = 0
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            step = int(record.get(step_key, n))
            writer.add_scalars(
                {k: v for k, v in record.items() if k != step_key}, step)
            n += 1
    writer.close()
    return n
