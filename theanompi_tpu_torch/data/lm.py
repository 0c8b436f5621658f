"""Language-model token datasets (port of ``theanompi_tpu/data/lm.py``).

An "image" is a token window ``[T] int32``; ``image_shape`` is ``(T,)``
and ``n_classes`` the vocabulary size. Labels ARE the token window (the
model shifts the targets), so batches are ``(tokens, tokens)`` pairs.
Both classes seed numpy exactly as the reference does, so the two
packages yield identical windows.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

from theanompi_tpu_torch.data.datasets import Dataset, register_dataset


@functools.lru_cache(maxsize=4)
def _successors(vocab: int, branching: int, seed: int) -> np.ndarray:
    """The chain's transition table, symbol -> ``branching`` successors
    (read-only). Drawn once a process for each (vocab, branching, seed):
    each row costs a permutation of the whole vocabulary, so the 136M
    LM's 32,768 symbols cost 32,768 permutations of 32,768."""
    rng = np.random.RandomState(seed)
    succ = np.stack([rng.choice(vocab, size=branching, replace=False) for _ in range(vocab)])
    succ.setflags(write=False)
    return succ


class LMSynthetic_data(Dataset):
    """Seeded order-1 Markov chain with LEARNABLE structure: each symbol
    has ``branching`` likely successors (uniform over them), with
    ``noise`` probability of a uniform-random symbol instead."""

    name = "lm_synthetic"

    def __init__(
        self,
        seq_len: int = 128,
        vocab: int = 64,
        n_train: int = 512,
        n_val: int = 64,
        branching: int = 4,
        noise: float = 0.05,
        seed: int = 1234,
    ):
        self.image_shape = (seq_len,)
        self.n_classes = vocab
        succ = _successors(vocab, branching, seed)

        def chain(n_windows, salt):
            r = np.random.RandomState(seed + salt)
            n_tok = n_windows * seq_len
            out = np.empty(n_tok, np.int32)
            s = r.randint(vocab)
            for i in range(n_tok):
                out[i] = s
                if r.rand() < noise:
                    s = r.randint(vocab)
                else:
                    s = succ[s, r.randint(branching)]
            return out.reshape(n_windows, seq_len)

        self.x_train = chain(n_train, 1)
        self.x_val = chain(n_val, 2)
        self.y_train = self.x_train  # targets = the window itself (shifted in-model)
        self.y_val = self.x_val


class LMText_data(Dataset):
    """Byte-level LM windows over a real text file (the repo's own docs
    by default): bytes concatenated, cut into non-overlapping ``seq_len``
    windows, the held-out TAIL fraction as validation."""

    name = "lm_text"

    DEFAULT_FILES = ("README.md", "SURVEY.md", "PARITY.md", "BASELINE.md")

    def __init__(
        self,
        path: Optional[str] = None,
        seq_len: int = 128,
        val_frac: float = 0.1,
    ):
        if path:
            paths = [path]
        else:
            root = os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            )
            paths = [
                p for f in self.DEFAULT_FILES
                if os.path.exists(p := os.path.join(root, f))
            ]
            if not paths:
                raise FileNotFoundError(
                    "lm_text: no default corpus files found; pass "
                    "dataset_kwargs={'path': <textfile>}"
                )
        blob = b""
        for p in paths:
            with open(p, "rb") as f:
                blob += f.read()
        toks = np.frombuffer(blob, np.uint8).astype(np.int32)
        n_win = len(toks) // seq_len
        if n_win < 8:
            raise ValueError(
                f"corpus too small: {len(toks)} bytes < 8 windows of {seq_len}"
            )
        wins = toks[: n_win * seq_len].reshape(n_win, seq_len)
        n_val = max(1, int(n_win * val_frac))
        self.image_shape = (seq_len,)
        self.n_classes = 256
        self.x_train = wins[: n_win - n_val]
        self.x_val = wins[n_win - n_val:]
        self.y_train = self.x_train
        self.y_val = self.x_val


register_dataset("lm_synthetic", LMSynthetic_data)
register_dataset("lm_text", LMText_data)
