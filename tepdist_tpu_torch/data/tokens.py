"""Memmapped token datasets: a copy of ``tepdist_tpu/data/tokens.py`` (numpy
only; the port keeps its own copy, since importing anything under
``tepdist_tpu`` imports jax). The file format and the batches drawn for a
seed are the JAX package's.

Design notes:
- Tokens live in one flat binary file, memmapped read-only: sampling a
  batch is a strided gather on the host, no parsing, no Python loop over
  documents. This is the layout nanoGPT-style training uses and is the
  fastest host-side format for LM training.
- Batches are drawn as ``[B, seq+1]`` windows (inputs + shifted targets in
  one array) to match ``gpt2.loss_fn``'s token-shift convention.
- ``prefetch.DevicePrefetcher`` copies batches to the device on a
  background thread so the host→device copy of the next batch overlaps the
  current step.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


_MAGIC = b"TPDT0001"


def encode_bytes(text: str) -> np.ndarray:
    """Byte-level tokenization (vocab 256): the zero-dependency fallback
    for demos/tests. Real runs pack pre-tokenized ids instead."""
    return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
        np.uint16)


def pack_token_file(tokens: np.ndarray, path: str) -> None:
    """Write a flat token file: 8-byte magic + dtype code + raw ids.
    uint16 for vocabs < 65536 (GPT-2's 50257 fits), uint32 otherwise."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got shape {tokens.shape}")
    dtype = np.uint16 if int(tokens.max(initial=0)) < 2 ** 16 else np.uint32
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.uint8(2 if dtype == np.uint16 else 4).tobytes())
        f.write(np.ascontiguousarray(tokens.astype(dtype)).tobytes())


class TokenDataset:
    """Random-window sampler over a memmapped token file."""

    def __init__(self, path: str):
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a tepdist token file")
            itemsize = int(np.frombuffer(f.read(1), np.uint8)[0])
        dtype = {2: np.uint16, 4: np.uint32}[itemsize]
        self.tokens = np.memmap(path, dtype=dtype, mode="r", offset=9,
                                shape=((size - 9) // itemsize,))

    def __len__(self) -> int:
        return len(self.tokens)

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> np.ndarray:
        """[batch, seq+1] int32 windows drawn uniformly (with replacement,
        the standard LM pretraining regime)."""
        n = len(self.tokens) - (seq + 1)
        if n < 0:
            raise ValueError(
                f"dataset has {len(self.tokens)} tokens < seq+1={seq + 1}")
        starts = rng.integers(0, n + 1, size=batch)
        return np.stack([self.tokens[s:s + seq + 1] for s in starts]
                        ).astype(np.int32)

    def batches(self, batch: int, seq: int, seed: int = 0
                ) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(seed)
        while True:
            yield self.sample(rng, batch, seq)
