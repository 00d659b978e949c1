"""Reader and writer of the safetensors format, in numpy and torch only.

The format: an 8-byte little-endian header length, a JSON header mapping
each name to {"dtype", "shape", "data_offsets": [begin, end]} (offsets into
the data that follows the header; an optional "__metadata__" entry of
strings), then the raw little-endian buffers. UniDepth's released weights
come as model.safetensors; this module reads them without the safetensors
package.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor for every tensor in a .safetensors file."""
    with open(path, "rb") as fh:
        buf = bytearray(os.fstat(fh.fileno()).st_size)
        fh.readinto(buf)
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    start, size = 8 + n, len(buf) - 8 - n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        count = int(np.prod(info["shape"], dtype=np.int64))
        if end - begin != count * torch.empty((), dtype=dtype).element_size() or end > size:
            raise ValueError(f"{path}: tensor {name} has data_offsets {begin, end} that do not fit "
                             f"its shape {info['shape']}")
        raw = (torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=start + begin)
               .clone() if end > begin else torch.empty(0, dtype=torch.uint8))
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def write_safetensors(path, tensors: Dict[str, torch.Tensor]) -> None:
    """Write name -> tensor as a .safetensors file (buffers in name order,
    header padded with spaces to a multiple of 8 bytes)."""
    header, arrays, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name}: unsupported dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + raw.size]}
        arrays.append(raw)
        offset += raw.size
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)) + text)
        for raw in arrays:
            fh.write(raw.data)
