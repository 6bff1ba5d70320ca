"""TensorBoard scalars, written a batch at a time.

A run's ``loss`` and ``logz`` scalars go to one event file of the trainer's
run directory, named by TensorBoard's ``events.out.tfevents.<time>.<host>``
convention and made at its first write; the ``SummaryWriter`` beside it
keeps the images and figures in a file of its own. TensorBoard and
``EventAccumulator`` read every event file of a directory.

Each row is the ``Event`` that ``SummaryWriter.add_scalar`` writes
(``wall_time``, ``step``, ``summary.value{tag, simple_value}``, the value
as float32), framed as a TFRecord (the length and the data each followed by
their masked CRC32C); a new file starts with the file-version event. The
native runtime (``runtime.write_scalar_events``) writes a batch in one call
that holds no GIL; where it is not built (no ``g++``),
:func:`encode_scalar_events` writes the same bytes.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time

import numpy as np

from nnest_torch import runtime

_FILE_VERSION = b'brain.Event:2'
# a process's event files, numbered as TensorBoard numbers its own
_file_ids = itertools.count()


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def masked_crc32c(data):
    """TFRecord's masked CRC32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    c ^= 0xFFFFFFFF
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(v):
    v &= 0xFFFFFFFFFFFFFFFF   # an int64 as protobuf encodes it
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _field(number, payload):
    """A length-delimited field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _wall_time(wall_time):
    """``Event.wall_time``; proto3 leaves out a zero."""
    bits = struct.pack('<d', wall_time)
    return b'\x09' + bits if bits != bytes(8) else b''


def _record(data):
    length = struct.pack('<Q', len(data))
    return (length + struct.pack('<I', masked_crc32c(length)) + data
            + struct.pack('<I', masked_crc32c(data)))


def encode_scalar_events(tag, steps, values, wall_times, new_file=False):
    """The TFRecord-framed scalar events of the rows, after the file-version
    event (at the first row's wall time) when ``new_file``: the bytes the
    native runtime appends."""
    steps = np.asarray(steps, dtype=np.int64)
    with np.errstate(over='ignore'):   # past float32's range: inf, as in C
        values = np.asarray(values, dtype=np.float64).astype('<f4')
    wall_times = np.asarray(wall_times, dtype=np.float64)
    out = []
    if new_file:
        out.append(_record(_wall_time(float(wall_times[0]))
                           + _field(3, _FILE_VERSION)))
    tag_field = _field(1, tag.encode()) if tag else b''
    for step, value, wall in zip(steps.tolist(), values, wall_times.tolist()):
        summary = _field(1, tag_field + b'\x15' + value.tobytes())
        step_field = b'\x10' + _varint(step) if step else b''
        out.append(_record(_wall_time(wall) + step_field
                           + _field(5, summary)))
    return b''.join(out)


class ScalarEventFile:
    """One scalar event file in ``log_dir``, made at the first
    :meth:`write`. Not thread-safe: its owner serialises the writes."""

    def __init__(self, log_dir):
        self.path = os.path.join(
            log_dir, 'events.out.tfevents.%010d.%s.%d.%d.scalars' % (
                time.time(), socket.gethostname(), os.getpid(),
                next(_file_ids)))

    def write(self, tag, steps, values, wall_times):
        """Append the rows' scalar events under ``tag``."""
        if len(steps) == 0:
            return
        if runtime.write_scalar_events(self.path, tag, steps, values,
                                       wall_times):
            return
        with open(self.path, 'ab') as f:
            new_file = f.seek(0, os.SEEK_END) == 0
            f.write(encode_scalar_events(tag, steps, values, wall_times,
                                         new_file))
