"""The safetensors file format, read and written with json and torch alone.

The port's own copy of what the JAX loader imports from the `safetensors`
package (mvoc_tpu/models/convert.py: load_torch_state_dict), so that the
port does not depend on that package.  A file is an 8-byte little-endian
header length N, N bytes of JSON {name: {"dtype", "shape", "data_offsets":
[begin, end]}, "__metadata__": {str: str}}, then the tensors' bytes, each
range relative to the end of the header.

`load_file` maps the file (copy-on-write, so nothing is written back) and
views each tensor on the mapping with `torch.frombuffer`: a 2.8 GB UNet
file is read once, by the copy that moves it to its device or dtype.  A
header that overruns the file, tensors whose ranges do not tile the data,
a size that does not match its shape, or an unknown dtype raise.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# a header is at most this long (the format's own limit, 100 MB)
MAX_HEADER = 100_000_000


def _header(buf, size: int, path: str) -> tuple[dict, int]:
    if size < 8:
        raise ValueError(f"{path}: {size} bytes is too short for a safetensors file")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > MAX_HEADER or 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes overruns the file ({size} bytes)")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"{path}: header is not JSON ({exc})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    return header, 8 + n


def _entries(header: dict, n_data: int, path: str) -> dict:
    """{name: (dtype, shape, begin, end)}, checked against the data's length."""
    out, spans = {}, []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {info.get('dtype')!r}")
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(x) for x in info["data_offsets"])
        numel = 1
        for d in shape:
            numel *= d
        if not 0 <= begin <= end <= n_data:
            raise ValueError(f"{path}: tensor {name!r} bytes [{begin}, {end}) overrun the "
                             f"{n_data} data bytes")
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes for shape "
                             f"{list(shape)} of {info['dtype']}")
        out[name] = (dtype, shape, begin, end)
        spans.append((begin, end))
    pos = 0
    for begin, end in sorted(spans):
        if begin != pos:
            raise ValueError(f"{path}: tensor data does not tile the file (gap or overlap at "
                             f"byte {begin})")
        pos = end
    if pos != n_data:
        raise ValueError(f"{path}: {n_data - pos} trailing bytes after the last tensor")
    return out


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file.  On the CPU the tensors are
    views of a private mapping of the file; on another device, copies."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
    header, base = _header(buf, size, path)
    out = {}
    for name, (dtype, shape, begin, end) in _entries(header, size - base, path).items():
        start = base + begin
        if end == begin:
            t = torch.empty(shape, dtype=dtype)
        elif start % dtype.itemsize:  # misaligned in the file: copy it out
            t = torch.frombuffer(bytearray(buf[start:base + end]), dtype=dtype).reshape(shape)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                 offset=start).reshape(shape)
        out[name] = t if str(device) == "cpu" else t.to(device)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write `tensors` (any device; copied to the host one at a time) as a
    safetensors file.  Larger items first, then by name, so every tensor
    starts aligned to its item size.  Returns the bytes written."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise ValueError("safetensors metadata must map str to str")
        header["__metadata__"] = dict(metadata)
    pos = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)
    return 8 + len(raw) + pos
