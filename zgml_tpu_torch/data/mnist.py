"""MNIST IDX-format loader; a copy of zgml_tpu/data/mnist.py:16-69 (numpy only).

Reads the standard IDX ubyte files (magic 0x803 images / 0x801 labels).
`write_synthetic_mnist` writes class-structured random digits in the same
format, byte for byte what the JAX package writes for the same arguments, so
the demos train without a download.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np


def _open(path):
    return gzip.open(path, "rb") if str(path).endswith(".gz") else open(path, "rb")


def load_images(path) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 0x803:
            raise ValueError(f"bad IDX image magic {magic:#x}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols)


def load_labels(path) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 0x801:
            raise ValueError(f"bad IDX label magic {magic:#x}")
        return np.frombuffer(f.read(n), np.uint8).copy()


def load_mnist(dir_path, split: str = "train"):
    """Returns (images [N,28,28] f32 in [0,1], labels [N] i32)."""
    prefix = "train" if split == "train" else "t10k"
    for ext in ("", ".gz"):
        ip = os.path.join(dir_path, f"{prefix}-images-idx3-ubyte{ext}")
        lp = os.path.join(dir_path, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(ip):
            return (load_images(ip).astype(np.float32) / 255.0,
                    load_labels(lp).astype(np.int32))
    raise FileNotFoundError(f"no MNIST files under {dir_path}")


def write_synthetic_mnist(dir_path, n_train: int = 512, n_test: int = 128,
                          seed: int = 0):
    """Class-structured synthetic digits in real IDX format: each class is a
    distinct blob pattern + noise, so classifiers can actually learn."""
    rng = np.random.default_rng(seed)
    os.makedirs(dir_path, exist_ok=True)
    protos = rng.random((10, 28, 28)).astype(np.float32)

    def make(n, prefix):
        labels = rng.integers(0, 10, n).astype(np.uint8)
        imgs = protos[labels] * 180 + rng.random((n, 28, 28)) * 60
        imgs = imgs.astype(np.uint8)
        with open(os.path.join(dir_path, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 0x803, n, 28, 28))
            f.write(imgs.tobytes())
        with open(os.path.join(dir_path, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
            f.write(struct.pack(">II", 0x801, n))
            f.write(labels.tobytes())

    make(n_train, "train")
    make(n_test, "t10k")
