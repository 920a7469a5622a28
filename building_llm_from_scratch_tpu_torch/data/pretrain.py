"""Pretraining data pipeline: sliding-window causal-LM batches (the port's
copy of the JAX package's ``data/pretrain.py``).

The same windows (``max_length`` tokens every ``stride``, targets shifted
by one), the same 90/10 character-level train/val split, the same
``np.random.default_rng(seed + epoch)`` shuffle and drop-last batching, so
the port's batches are the JAX loader's integers. Tokenization happens once
per file and loader (``TokenCache``), and with ``--tokenizer_cache_dir``
once per file and cache directory: the cache files are the JAX package's.
Batches are numpy int32 arrays; the trainer moves them to the device.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from building_llm_from_scratch_tpu_torch.utils.io import read_text_file

logger = logging.getLogger(__name__)


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
    """Tokenize-once cache of the pretrain path (the JAX ``TokenCache``).

    One entry per (file identity, tokenizer, max_length, stride,
    train_ratio, eos text): the (train_ids, val_ids) pair of the character
    split. File identity is (abspath, mtime_ns, size): an edited corpus
    misses and re-encodes. The tokenizer is its class name, vocab size and
    a digest of the ids of a probe text, so a cache directory shared by
    runs never serves ids of another vocabulary. With ``cache_dir`` each
    entry is also a ``tok_<digest>.npz`` file (``train``, ``val``) there,
    the JAX package's name and layout, so either package reads the other's
    files: a relaunch reads them instead of tokenizing. A file that does not
    load is re-tokenized (with a warning); a failed write only warns.
    ``stats`` counts the files read from disk and tokenized, and the
    seconds each took."""

    #: mixed case, digits, punctuation and whitespace: two vocab files of
    #: one class and size encode it differently
    _PROBE = "The 3 quick brown foxes JUMPED over 42 lazy dogs!?\n\t'"

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir
        self._mem: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}
        self.stats = dict(disk=0, encoded=0, disk_seconds=0.0,
                          encode_seconds=0.0)

    @classmethod
    def _tokenizer_id(cls, tokenizer) -> str:
        fp = getattr(tokenizer, "_token_cache_fp", None)
        if fp is None:
            try:
                ids = tokenizer.encode(cls._PROBE)
                fp = hashlib.sha256(
                    np.asarray(ids, np.int64).tobytes()).hexdigest()[:12]
            except Exception:  # an encode() of another signature: class
                fp = "noprobe"  # and vocab size alone
            try:
                tokenizer._token_cache_fp = fp
            except AttributeError:   # __slots__: probe again next time
                pass
        return (f"{type(tokenizer).__name__}"
                f"-v{getattr(tokenizer, 'vocab_size', '')}-{fp}")

    def _key(self, path: str, tokenizer, max_length: int, stride: int,
             train_ratio: float, eos_text: str) -> tuple:
        st = os.stat(path)
        return (os.path.abspath(path), st.st_mtime_ns, st.st_size,
                self._tokenizer_id(tokenizer), int(max_length), int(stride),
                round(float(train_ratio), 6), eos_text)

    def _disk_path(self, key: tuple) -> Optional[str]:
        if self.cache_dir is None:
            return None
        digest = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        return os.path.join(self.cache_dir, f"tok_{digest}.npz")

    def get(self, path: str, tokenizer, max_length: int, stride: int,
            train_ratio: float, eos_text: str,
            encode_fn: Callable[[str], Tuple[np.ndarray, np.ndarray]]
            ) -> Tuple[np.ndarray, np.ndarray]:
        """(train_ids, val_ids) of ``path``; ``encode_fn(path)`` runs only
        when neither memory nor the cache directory holds them."""
        try:
            key = self._key(path, tokenizer, max_length, stride, train_ratio,
                            eos_text)
        except OSError:
            return encode_fn(path)      # no file identity to key on
        hit = self._mem.get(key)
        if hit is not None:
            return hit
        disk = self._disk_path(key)
        if disk is not None and os.path.isfile(disk):
            t0 = time.perf_counter()
            try:
                with np.load(disk) as z:
                    pair = (np.asarray(z["train"], np.int32),
                            np.asarray(z["val"], np.int32))
                self._mem[key] = pair
                self.stats["disk"] += 1
                self.stats["disk_seconds"] += time.perf_counter() - t0
                return pair
            except Exception as e:   # corrupt cache file: re-tokenize
                logger.warning("Token cache %s unreadable (%s); "
                               "re-tokenizing.", disk, e)
        t0 = time.perf_counter()
        pair = encode_fn(path)
        pair = (np.asarray(pair[0], np.int32), np.asarray(pair[1], np.int32))
        self._mem[key] = pair
        self.stats["encoded"] += 1
        self.stats["encode_seconds"] += time.perf_counter() - t0
        if disk is not None:
            try:
                os.makedirs(self.cache_dir, exist_ok=True)
                tmp = disk + ".tmp"
                np.savez(tmp, train=pair[0], val=pair[1])
                # np.savez appends .npz to paths without it
                os.replace(tmp if os.path.exists(tmp) else tmp + ".npz",
                           disk)
            except OSError as e:     # a cache write must not end a run
                logger.warning("Token cache write to %s failed (%s).",
                               disk, e)
        return pair


class PretrainLoader:
    """Batched loader over one or more raw-text corpora: 90/10 character
    split, shuffled fixed-shape batches. With ``process_count`` ranks a
    step's global batch is ``batch_size x process_count`` windows of the
    (seed, epoch) shuffle, and rank ``process_index`` takes every
    ``process_count``-th of them from its index on (the JAX loader's
    ``sl[process_index::process_count]``)."""

    def __init__(self, tokenizer, batch_size: int, max_length: int,
                 stride: Optional[int] = None, train_ratio: float = 0.90,
                 seed: int = 123, token_cache_dir: Optional[str] = None,
                 process_index: int = 0, process_count: int = 1):
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.stride = stride or max_length
        self.train_ratio = train_ratio
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.token_cache = TokenCache(token_cache_dir)

    def split_text(self, text: str) -> Tuple[str, str]:
        """Character-level split at ``train_ratio``."""
        split_idx = int(self.train_ratio * len(text))
        return text[:split_idx], text[split_idx:]

    def _file_token_ids(self, path: str, eos_text: str
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(train_ids, val_ids) of one corpus file + `` {eos_text} ``.

        ``<|endoftext|>`` and the suffix are the allowed specials: LLaMA-3's
        ``<|end_of_text|>`` becomes its eos id, where the JAX loader allows
        ``<|endoftext|>`` alone and its LLaMA-3 tokenizer raises on the
        suffix. Any other special in the corpus raises ``ValueError``."""
        allowed = {"<|endoftext|>", eos_text}

        def encode(p: str) -> Tuple[np.ndarray, np.ndarray]:
            text = read_text_file(p) + f" {eos_text} "
            train_text, val_text = self.split_text(text)
            enc = lambda t: np.asarray(  # noqa: E731
                self.tokenizer.encode(t, allowed_special=allowed), np.int32)
            return enc(train_text), enc(val_text)

        return self.token_cache.get(path, self.tokenizer, self.max_length,
                                    self.stride, self.train_ratio, eos_text,
                                    encode)

    def create_datasets_for_file(self, path: str, eos_text: str
                                 ) -> Tuple[PretrainDataset, PretrainDataset]:
        train_ids, val_ids = self._file_token_ids(path, eos_text)
        return (PretrainDataset(train_ids, self.max_length, self.stride),
                PretrainDataset(val_ids, self.max_length, self.stride))

    def batches(self, dataset: PretrainDataset, *, shuffle: bool = True,
                epoch: int = 0, start: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Fixed-shape (inputs, targets) batches of this rank's rows,
        shuffled deterministically in (seed, epoch); a partial last global
        batch is dropped. ``start`` begins at that batch of the same order
        (a resumed run's fast-forward: the skipped batches are not
        built)."""
        n = len(dataset)
        order = np.arange(n)
        if shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        gbs = self.batch_size * self.process_count
        for b in range(start, self._num_batches(n)):
            rows = order[b * gbs:(b + 1) * gbs][self.process_index::self.process_count]
            yield dataset.inputs[rows], dataset.targets[rows]

    def _num_batches(self, n_windows: int) -> int:
        return n_windows // (self.batch_size * self.process_count)

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
