"""Worker process of data/streams.py::_ahead.

Started as `python -m batrack_tpu_torch.data.decode_worker`, it imports
only what its jobs need (numpy for PNG frames, cv2 too for JPEG frames; no
torch, and never the parent's main module, as multiprocessing's spawn
would). Each job on stdin is a pickled
(module, function name, args); each answer on stdout is a pickled
("ok", result) or ("error", exception). Both are framed by an 8-byte
little-endian length. It exits at the end of its input.
"""

from __future__ import annotations

import importlib
import pickle
import struct
import sys


def send(stream, obj) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(struct.pack("<Q", len(blob)) + blob)
    stream.flush()


def receive(stream):
    """The next framed object, or None at the end of the stream."""
    head = stream.read(8)
    if len(head) < 8:
        return None
    n = struct.unpack("<Q", head)[0]
    blob = stream.read(n)
    if len(blob) < n:
        return None
    return pickle.loads(blob)


def main() -> int:
    src, dst = sys.stdin.buffer, sys.stdout.buffer
    while True:
        job = receive(src)
        if job is None:
            return 0
        module, name, args = job
        try:
            answer = ("ok", getattr(importlib.import_module(module), name)(*args))
        except Exception as e:  # handed to the reader
            answer = ("error", e)
        try:
            send(dst, answer)
        except (pickle.PicklingError, TypeError, AttributeError) as e:
            send(dst, ("error", RuntimeError(f"{module}.{name}: unpicklable answer ({e!r})")))


if __name__ == "__main__":
    sys.exit(main())
