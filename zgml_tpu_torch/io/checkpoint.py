"""Checkpoint save/load in the JAX package's ZGMT format
(zgml_tpu/io/checkpoint.py:1-11), so each package reads the other's files.

Format: [magic 'ZGMT'][version u32][n u64] then per entry:
  [name_len u16][name utf8][dtype_len u8][dtype str][ndim u8][dims u64...]
  [nbytes u64][raw little-endian data]

A tree is nested dicts / lists of tensors (or numpy arrays); each leaf is
named by its '/'-joined path of dict keys and list indices, in the JAX
package's order (utils/tree.py), e.g. {"params": ..., "opt": adam state}.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

from zgml_tpu_torch.utils.tree import flatten, paths

MAGIC = b"ZGMT"
VERSION = 1


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError("ZGMT stores numpy dtypes: cast bf16 leaves before saving")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any):
    with open(path, "wb") as f:
        entries = paths(tree)
        f.write(MAGIC)
        f.write(struct.pack("<IQ", VERSION, len(entries)))
        for name, leaf in entries:
            arr = _np(leaf)
            nb = name.encode()
            dt = arr.dtype.str.encode()   # e.g. '<f4'
            f.write(struct.pack("<H", len(nb)) + nb)
            f.write(struct.pack("<B", len(dt)) + dt)
            f.write(struct.pack("<B", arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<Q", d))
            raw = np.ascontiguousarray(arr).tobytes()
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)


def load_checkpoint(path: str, like: Any) -> Any:
    """Load into the structure of `like`, verifying names and shapes; each
    leaf comes back as a tensor of the file's dtype on the device of the
    matching leaf of `like` (the CPU where that leaf is not a tensor). Entries
    go to their device one at a time, so the host holds one entry at most."""
    expect = dict(paths(like))
    loaded: dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError("bad checkpoint magic")
        version, n = struct.unpack("<IQ", f.read(12))
        if version != VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        if n != len(expect):
            raise ValueError(f"checkpoint has {n} params, model expects {len(expect)}")
        for _ in range(n):
            (nlen,) = struct.unpack("<H", f.read(2))
            name = f.read(nlen).decode()
            (dlen,) = struct.unpack("<B", f.read(1))
            dtype = np.dtype(f.read(dlen).decode())
            (ndim,) = struct.unpack("<B", f.read(1))
            shape = tuple(struct.unpack("<Q", f.read(8))[0] for _ in range(ndim))
            (nbytes,) = struct.unpack("<Q", f.read(8))
            raw = bytearray(f.read(nbytes))
            if name not in expect:
                continue            # reported below as the missing name it stands for
            leaf = expect[name]
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if shape != want:
                raise ValueError(f"shape mismatch for {name}: {shape} vs {want}")
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            loaded[name] = torch.from_numpy(np.frombuffer(raw, dtype).reshape(shape)).to(dev)
    missing = [name for name in expect if name not in loaded]
    if missing:
        raise KeyError(f"checkpoint missing param {missing[0]!r}")
    return flatten(like)[1]([loaded[name] for name, _ in paths(like)])
