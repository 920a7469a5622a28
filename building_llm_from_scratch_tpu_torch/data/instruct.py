"""Instruction-finetuning data (the port's copy of the JAX package's
``data/instruct.py``): Alpaca-format records with loss masking.

The same Alpaca and Phi templates, the same pre-tokenized prompt+response
records with their prompt lengths, and the same fixed-shape collate: (B,
max_length) inputs and targets and an fp32 ``loss_weight`` that is 1.0 where
the reference supervises and 0.0 where it writes the ignore index (the
padding after the first pad target, which supervises the eos, and the
instruction prefix). A weighted-mean cross entropy over these weights is
torch's ``F.cross_entropy`` mean over the supervised positions. The 90/10
record split, the ``np.random.default_rng(seed + epoch)`` shuffle and
drop-last batching are the JAX loader's, so the port's batches are its
integers. Batches are numpy arrays; the trainer moves them to the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from building_llm_from_scratch_tpu_torch.utils.io import read_json_file


def format_input(entry: Dict[str, str]) -> str:
    """The Alpaca prompt template."""
    instruction_text = (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request."
        f"\n\n### Instruction:\n{entry['instruction']}"
    )
    input_text = f"\n\n### Input:\n{entry['input']}" if entry.get("input") else ""
    return instruction_text + input_text


def format_input_phi(entry: Dict[str, str]) -> str:
    """The Phi-style template."""
    instruction_text = f"<|user|>\n{entry['instruction']}"
    input_text = f"\n{entry['input']}" if entry.get("input") else ""
    return instruction_text + input_text


class InstructionDataset:
    """Each record's prompt+response token ids and its prompt length (the
    collate masks the prompt)."""

    def __init__(self, data: Sequence[Dict[str, str]], tokenizer,
                 style: str = "alpaca"):
        fmt = format_input if style == "alpaca" else format_input_phi
        resp_prefix = ("\n\n### Response:\n" if style == "alpaca"
                       else "\n<|assistant|>:\n")
        self.data = list(data)
        self.encoded_texts: List[List[int]] = []
        self.instruction_lengths: List[int] = []
        for entry in self.data:
            prompt = fmt(entry)
            full_text = prompt + resp_prefix + entry["output"]
            self.encoded_texts.append(tokenizer.encode(full_text))
            self.instruction_lengths.append(len(tokenizer.encode(prompt)))

    def __getitem__(self, index: int) -> Tuple[int, List[int]]:
        return self.instruction_lengths[index], self.encoded_texts[index]

    def __len__(self) -> int:
        return len(self.data)


def collate_batch(batch: Sequence[Tuple[int, List[int]]], *,
                  pad_token_id: int, allowed_max_length: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-shape collate: (inputs, targets, loss_weight), each
    (B, allowed_max_length). Per row: the tokens plus one pad (the eos),
    padded to T + 1 and truncated; inputs = seq[:-1], targets = seq[1:];
    weight 0 on every pad target but the first and on the instruction
    prefix (targets[:instr_len - 1]), 1 elsewhere. As in the reference, a
    genuine occurrence of the pad id past the first is masked too."""
    T = allowed_max_length
    B = len(batch)
    inputs = np.full((B, T), pad_token_id, np.int32)
    targets = np.full((B, T), pad_token_id, np.int32)
    weights = np.zeros((B, T), np.float32)
    for i, (instr_len, item) in enumerate(batch):
        seq = list(item) + [pad_token_id]
        seq = (seq + [pad_token_id] * (T + 1 - len(seq)))[: T + 1]
        row_in = np.asarray(seq[:-1], np.int32)
        row_tg = np.asarray(seq[1:], np.int32)
        w = np.ones(T, np.float32)
        pad_pos = np.nonzero(row_tg == pad_token_id)[0]
        if len(pad_pos) > 1:
            w[pad_pos[1:]] = 0.0
        w[: max(0, instr_len - 1)] = 0.0
        inputs[i], targets[i], weights[i] = row_in, row_tg, w
    return inputs, targets, weights


class InstructLoader:
    """Instruction-finetuning batches: the 90/10 record split, shuffled
    fixed-shape batches (drop-last); with ``process_count`` ranks each
    takes its rows of the global batch, as ``PretrainLoader`` does."""

    def __init__(self, tokenizer, batch_size: int, max_length: int,
                 pad_token_id: int, dataset_name: str = "alpaca",
                 train_ratio: float = 0.90, seed: int = 123,
                 process_index: int = 0, process_count: int = 1):
        if dataset_name.lower() not in ("alpaca",):
            raise ValueError(f"Dataset '{dataset_name}' is not supported.")
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.train_ratio = train_ratio
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def create_datasets(self, records: Sequence[Dict[str, str]]
                        ) -> Tuple[InstructionDataset, InstructionDataset]:
        split = int(self.train_ratio * len(records))
        return (InstructionDataset(records[:split], self.tokenizer),
                InstructionDataset(records[split:], self.tokenizer))

    def batches(self, dataset: InstructionDataset, *, shuffle: bool = True,
                epoch: int = 0, start: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Collated batches of this rank's records in the (seed, epoch)
        shuffle, drop-last; ``start`` begins at that batch of the same
        order without collating the skipped ones (a resumed run's
        fast-forward)."""
        order = np.arange(len(dataset))
        if shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        gbs = self.batch_size * self.process_count
        for b in range(start, self.num_batches(dataset)):
            mine = order[b * gbs:(b + 1) * gbs][self.process_index::self.process_count]
            yield collate_batch([dataset[j] for j in mine],
                                pad_token_id=self.pad_token_id,
                                allowed_max_length=self.max_length)

    def num_batches(self, dataset: InstructionDataset) -> int:
        return len(dataset) // (self.batch_size * self.process_count)

    def get_total_steps_epoch(self, files: List[str],
                              read_fn: Optional[Callable] = None) -> int:
        """Train batches of one epoch over ``files`` (Alpaca ``.json``)."""
        read_fn = read_fn or read_json_file
        total = 0
        for path in files:
            train, _ = self.create_datasets(read_fn(path))
            total += self.num_batches(train)
        return total
