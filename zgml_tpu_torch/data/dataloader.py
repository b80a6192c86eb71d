"""Batched data loader with epoch shuffling; counterpart of
zgml_tpu/data/dataloader.py, with the same numpy generator, so both
packages give the same batches from one seed."""
from __future__ import annotations

import numpy as np


class DataLoader:
    def __init__(self, *arrays, batch_size: int = 32, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("array length mismatch")
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.n = n

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = self._rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        end = (self.n - self.batch_size + 1) if self.drop_last else self.n
        for i in range(0, max(end, 0), self.batch_size):
            sel = idx[i:i + self.batch_size]
            yield tuple(a[sel] for a in self.arrays)
