"""safetensors read and write.

Counterpart of zgml_tpu/io/safetensors.py (the same format and header, so
both packages write the same bytes): [8-byte LE header length][JSON header]
[raw tensor data]. The JSON maps tensor name -> {dtype, shape,
data_offsets=[begin, end]} relative to the data section, plus an optional
"__metadata__" object. Reads are numpy views over an mmap; BF16 payloads
widen to f32 by a bit shift (numpy has no bfloat16).
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": None,  # handled specially (numpy has no bfloat16)
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_TO_ST = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
          np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
          np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
          np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
          np.dtype(np.bool_): "BOOL"}


class SafetensorsFile:
    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        (hlen,) = struct.unpack("<Q", self._mm[:8])
        header = json.loads(self._mm[8:8 + hlen].decode("utf-8"))
        self.metadata: dict[str, Any] = header.pop("__metadata__", {})
        self.entries = header
        self._data_start = 8 + hlen

    def keys(self):
        return self.entries.keys()

    def tensor(self, name: str, copy: bool = True) -> np.ndarray:
        """copy=False returns a zero-copy view into the mmap, which must not
        outlive this file."""
        out = self._tensor_view(name)
        return out.copy() if copy else out

    def _tensor_view(self, name: str) -> np.ndarray:
        ent = self.entries[name]
        begin, end = ent["data_offsets"]
        raw = np.frombuffer(self._mm, np.uint8,
                            count=end - begin,
                            offset=self._data_start + begin)
        st_dtype = ent["dtype"]
        shape = tuple(ent["shape"])
        if st_dtype == "BF16":
            # bf16 -> f32 via bit-shift (numpy lacks bfloat16)
            u16 = raw.view(np.uint16).astype(np.uint32) << 16
            return u16.view(np.float32).reshape(shape)
        dt = _DTYPES.get(st_dtype)
        if dt is None:
            raise NotImplementedError(f"dtype {st_dtype}")
        return raw.view(dt).reshape(shape)

    def close(self):
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_safetensors(path: str | os.PathLike, tensors: dict[str, np.ndarray],
                     metadata: dict[str, str] | None = None):
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        st = _TO_ST.get(arr.dtype)
        if st is None and arr.dtype.name == "bfloat16":
            st = "BF16"          # ml_dtypes.bfloat16 (bf16 scale storage)
        if st is None:
            raise NotImplementedError(f"dtype {arr.dtype}")
        raw = arr.tobytes()
        header[name] = {"dtype": st, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    hjson = json.dumps(header).encode("utf-8")
    pad = (8 - len(hjson) % 8) % 8   # align like HF writers do
    hjson += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for raw in blobs:
            f.write(raw)
