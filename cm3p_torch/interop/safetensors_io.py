"""Reader and writer of the safetensors file layout, in numpy.

The layout: 8 bytes holding the header's length N as a little-endian unsigned
integer, N bytes of JSON mapping each tensor name to ``{"dtype", "shape",
"data_offsets": [begin, end]}`` (plus an optional ``"__metadata__"`` map of
strings), then the tensors' raw little-endian C-contiguous buffers, offsets
relative to the end of the header. This module handles F32, F16, BF16 and I64,
the types a checkpoint bundle holds (the shards of a published checkpoint are
often F16); numpy has no bfloat16, so BF16 tensors are read as float32 (exact)
and written from float32 with round-to-nearest-even.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np

_DTYPES = {"F32": np.float32, "F16": np.float16, "I64": np.int64}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))  # nearest, ties to even
    bits = np.where(np.isnan(x), np.uint32(0x7FC00000), rounded) >> 16
    return bits.astype(np.uint16)


def load_file(path: Union[str, Path]) -> dict[str, np.ndarray]:
    """All tensors of a safetensors file as numpy arrays (BF16 as float32, F16 as float16)."""
    buf = Path(path).read_bytes()
    if len(buf) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its length field)")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(buf[8 : 8 + n].decode("utf-8"))
    data = memoryview(buf)[8 + n :]
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = data[begin:end]
        if info["dtype"] == "BF16":
            arr = _bf16_bits_to_f32(np.frombuffer(raw, dtype="<u2"))
        elif info["dtype"] in _DTYPES:
            arr = np.frombuffer(raw, dtype=np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")).copy()
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} has {arr.size} elements for shape {shape}")
        out[name] = arr.reshape(shape)
    return out


def save_file(
    tensors: dict[str, np.ndarray],
    path: Union[str, Path],
    metadata: Optional[dict[str, str]] = None,
    bf16: bool = False,
) -> None:
    """Write ``tensors`` as a safetensors file; with ``bf16`` float32 arrays are stored as BF16."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    chunks: list[bytes] = []
    offset = 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        if bf16 and arr.dtype == np.float32:
            dtype, raw = "BF16", _f32_to_bf16_bits(arr).astype("<u2").tobytes()
        elif arr.dtype in _NAMES:
            dtype, raw = _NAMES[arr.dtype], np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes()
        else:
            raise ValueError(f"tensor {name!r} has unsupported dtype {arr.dtype}")
        header[name] = {"dtype": dtype, "shape": list(arr.shape), "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in chunks:
            f.write(raw)
