"""Pretraining data pipeline: sliding-window causal-LM batches (the port's
copy of the JAX package's ``data/pretrain.py``).

The same windows (``max_length`` tokens every ``stride``, targets shifted
by one), the same 90/10 character-level train/val split, the same
``np.random.default_rng(seed + epoch)`` shuffle and drop-last batching, so
the port's batches are the JAX loader's integers. Tokenization happens once
per file and loader (an in-memory ``TokenCache``); the JAX package's
on-disk cache (``--tokenizer_cache_dir``) is not ported. Batches are numpy
int32 arrays; the trainer moves them to the device.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from building_llm_from_scratch_tpu_torch.utils.io import read_text_file


def make_windows(token_ids: np.ndarray, max_length: int,
                 stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows: inputs (N, T) and shifted targets (N, T), both
    read-only views over ``token_ids`` (no copies); partial trailing
    windows are dropped."""
    token_ids = np.ascontiguousarray(token_ids, dtype=np.int32)
    n = len(token_ids) - max_length          # need max_length+1 tokens per row
    if n <= 0:
        return (np.zeros((0, max_length), np.int32),
                np.zeros((0, max_length), np.int32))
    win = np.lib.stride_tricks.sliding_window_view(
        token_ids, max_length + 1)[:n:stride]
    return win[:, :-1], win[:, 1:]


class PretrainDataset:
    """The windows of one split's token ids."""

    def __init__(self, token_ids: np.ndarray, max_length: int, stride: int):
        self.token_ids = np.asarray(token_ids, dtype=np.int32)
        self.inputs, self.targets = make_windows(self.token_ids, max_length,
                                                 stride)

    def __len__(self) -> int:
        return len(self.inputs)


def _num_windows(n_tokens: int, max_length: int, stride: int) -> int:
    """len(PretrainDataset) of ``n_tokens`` tokens, without building it."""
    n = n_tokens - max_length
    return 0 if n <= 0 else len(range(0, n, stride))


class TokenCache:
    """In-memory tokenize-once cache: one (train_ids, val_ids) pair per file
    identity (path, mtime, size) and split settings, so the total-steps
    pre-pass and every epoch reuse one tokenization per file."""

    def __init__(self):
        self._mem: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}

    def get(self, path: str, key: tuple,
            encode_fn: Callable[[str], Tuple[np.ndarray, np.ndarray]]
            ) -> Tuple[np.ndarray, np.ndarray]:
        st = os.stat(path)
        full = (os.path.abspath(path), st.st_mtime_ns, st.st_size) + key
        if full not in self._mem:
            tr, va = encode_fn(path)
            self._mem[full] = (np.asarray(tr, np.int32), np.asarray(va, np.int32))
        return self._mem[full]


class PretrainLoader:
    """Batched loader over one or more raw-text corpora: 90/10 character
    split, shuffled fixed-shape batches (one process: the JAX loader's
    per-process row sharding is not ported)."""

    def __init__(self, tokenizer, batch_size: int, max_length: int,
                 stride: Optional[int] = None, train_ratio: float = 0.90,
                 seed: int = 123):
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.stride = stride or max_length
        self.train_ratio = train_ratio
        self.seed = seed
        self.token_cache = TokenCache()

    def split_text(self, text: str) -> Tuple[str, str]:
        """Character-level split at ``train_ratio``."""
        split_idx = int(self.train_ratio * len(text))
        return text[:split_idx], text[split_idx:]

    def _file_token_ids(self, path: str, eos_text: str
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(train_ids, val_ids) of one corpus file + `` {eos_text} ``."""

        def encode(p: str) -> Tuple[np.ndarray, np.ndarray]:
            text = read_text_file(p) + f" {eos_text} "
            train_text, val_text = self.split_text(text)
            enc = lambda t: np.asarray(  # noqa: E731
                self.tokenizer.encode(t, allowed_special={"<|endoftext|>"}),
                np.int32)
            return enc(train_text), enc(val_text)

        key = (self.max_length, self.stride, round(self.train_ratio, 6),
               eos_text)
        return self.token_cache.get(path, key, encode)

    def create_datasets_for_file(self, path: str, eos_text: str
                                 ) -> Tuple[PretrainDataset, PretrainDataset]:
        train_ids, val_ids = self._file_token_ids(path, eos_text)
        return (PretrainDataset(train_ids, self.max_length, self.stride),
                PretrainDataset(val_ids, self.max_length, self.stride))

    def batches(self, dataset: PretrainDataset, *, shuffle: bool = True,
                epoch: int = 0, start: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Fixed-shape (inputs, targets) batches, shuffled
        deterministically in (seed, epoch); a partial last batch is
        dropped. ``start`` begins at that batch of the same order (a
        resumed run's fast-forward: the skipped batches are not built)."""
        n = len(dataset)
        order = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        bs = self.batch_size
        for b in range(start, self._num_batches(n)):
            rows = order[b * bs:(b + 1) * bs]
            yield dataset.inputs[rows], dataset.targets[rows]

    def _num_batches(self, n_windows: int) -> int:
        return n_windows // self.batch_size

    def num_batches(self, dataset: PretrainDataset) -> int:
        return self._num_batches(len(dataset))

    def get_total_steps_epoch(self, files: List[str],
                              eos_text: str = "<|endoftext|>") -> int:
        """Optimizer steps per epoch over all corpus files (warms the token
        cache)."""
        total = 0
        for path in files:
            train_ids, _ = self._file_token_ids(path, eos_text)
            total += self._num_batches(
                _num_windows(len(train_ids), self.max_length, self.stride))
        return total
