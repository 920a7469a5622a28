"""The training engine (port of the single-device pretraining core of the
JAX package's ``training/trainer.py``).

Per-file epochs over shuffled fixed-shape batches, the warmup+cosine LR
over the precomputed total steps, evaluation every ``eval_freq`` steps on
at most ``EVAL_ITERS`` batches of each split, a greedy sample every
``print_sample_iter`` steps (and one before the first step), and the final
``.npz`` export. The step loop never waits on the device between cadence
points: per-step metrics stay device tensors until the evaluation cadence
fetches them.

Not ported yet: train-state checkpoints and resume, LoRA, instruction
finetuning, sharded plans, prefetching, profiling, the loss watchdog, the
stall detector and the metrics sink (obs/).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.generate import (
    generate,
    text_to_token_ids,
    token_ids_to_text,
)
from building_llm_from_scratch_tpu_torch.models.transformer import Transformer
from building_llm_from_scratch_tpu_torch.training.checkpoint import export_params
from building_llm_from_scratch_tpu_torch.training.optim import (
    AdamW,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu_torch.training.train_step import (
    init_train_state,
    make_eval_step,
    make_train_step,
)

logger = logging.getLogger(__name__)

#: batches of each split per evaluation (the JAX CLI's ``eval_iters``)
EVAL_ITERS = 5


class Trainer:
    """Drives pretraining (``train_model``) over a file list: one model, one
    optimizer."""

    def __init__(self, cfg: ModelConfig, model: Transformer, tokenizer, loader,
                 *, output_dir: str = "model_checkpoints",
                 peak_lr: float = 5e-4, initial_lr: float = 1e-5,
                 min_lr: float = 1e-6, warmup_steps: int = 10,
                 eval_freq: int = 10, print_sample_iter: int = 10,
                 seed: int = 123):
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.loader = loader
        self.output_dir = output_dir
        self.opt_hparams = dict(peak_lr=peak_lr, initial_lr=initial_lr,
                                min_lr=min_lr, warmup_steps=warmup_steps)
        self.eval_freq = eval_freq
        self.print_sample_iter = print_sample_iter
        #: the dropout stream's seed (the JAX trainer's PRNGKey(seed))
        self.seed = seed

        self.state = None
        self.global_step = 0
        self.tokens_seen = 0
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self.track_lrs: List[float] = []
        self.track_tokens_seen: List[int] = []
        #: training tokens/s of each evaluation window (sample time left out)
        self.throughput_tokens_per_s: List[float] = []
        #: sample texts, in order (the warm-up sample first)
        self.samples: List[str] = []
        #: per-step metrics as host floats (step, loss, grad_norm,
        #: update_norm, lr, tokens), fetched at the evaluation cadence
        self.step_metrics: List[Dict[str, Any]] = []
        self._pending: List[tuple] = []

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def _setup(self, total_steps: int) -> None:
        """Optimizer, schedule and steps once the total steps are known."""
        h = self.opt_hparams
        self.lr_schedule = warmup_cosine_schedule(
            h["peak_lr"], h["initial_lr"], h["min_lr"], h["warmup_steps"],
            total_steps)
        self.optimizer = AdamW(self.lr_schedule)
        self.state = init_train_state(self.model, self.optimizer, self.seed)
        self.train_step = make_train_step(self.cfg, self.optimizer)
        self.eval_step = make_eval_step(self.cfg)

    def _device_batch(self, arrays) -> Dict[str, torch.Tensor]:
        dev = self.model.device
        inputs, targets = arrays
        return {"inputs": torch.from_numpy(np.asarray(inputs, np.int64)).to(dev),
                "targets": torch.from_numpy(np.asarray(targets, np.int64)).to(dev)}

    # ------------------------------------------------------------------
    # evaluation / sampling
    # ------------------------------------------------------------------

    def calc_loss_loader(self, batches, num_batches: Optional[int] = None
                         ) -> float:
        losses = []
        for i, arrays in enumerate(batches):
            if num_batches is not None and i >= num_batches:
                break
            losses.append(float(self.eval_step(self.state,
                                               self._device_batch(arrays))))
        return float(np.mean(losses)) if losses else float("nan")

    def evaluate_model(self, train_batches, val_batches):
        return (self.calc_loss_loader(train_batches, EVAL_ITERS),
                self.calc_loss_loader(val_batches, EVAL_ITERS))

    def generate_and_print_sample(self, start_context: str,
                                  max_new_tokens: int = 50) -> str:
        ids = text_to_token_ids(start_context, self.tokenizer)
        ids = ids[:, -self.cfg.context_length:]
        out = generate(self.model, ids, max_new_tokens=max_new_tokens,
                       context_size=self.cfg.context_length,
                       eos_id=self.cfg.eos_id)
        text = token_ids_to_text(out, self.tokenizer)
        logger.info("Sample: %s", text.replace("\n", " "))
        self.samples.append(text)
        return text

    # ------------------------------------------------------------------
    # core loop
    # ------------------------------------------------------------------

    def _flush_metrics(self) -> None:
        """Fetch the pending per-step device metrics as host floats."""
        for step, m in self._pending:
            self.step_metrics.append(dict(
                step=step, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]),
                update_norm=float(m["update_norm"]), lr=m["lr"],
                tokens=m["tokens"]))
        self._pending.clear()

    def _run_epoch(self, train_batches_fn: Callable[[int], Any],
                   val_batches_fn: Callable[[int], Any], epoch: int,
                   start_context: str) -> None:
        """One pass over one file's batches with the cadence work."""
        if self.global_step == 0 and not self.samples:
            self.generate_and_print_sample(start_context)
        t_tokens, t_start, excluded = 0, time.perf_counter(), 0.0
        for arrays in train_batches_fn(epoch):
            n_tok = int(np.prod(arrays[0].shape))
            self.state, metrics = self.train_step(self.state,
                                                  self._device_batch(arrays))
            self.global_step += 1
            self.tokens_seen += n_tok
            t_tokens += n_tok
            self.track_lrs.append(metrics["lr"])
            self._pending.append((self.global_step, metrics))

            if self.global_step % self.eval_freq == 0:
                self._flush_metrics()      # waits for the step's device work
                tps = t_tokens / max(time.perf_counter() - t_start - excluded,
                                     1e-9)
                self.throughput_tokens_per_s.append(tps)
                train_loss, val_loss = self.evaluate_model(
                    train_batches_fn(epoch), val_batches_fn(epoch))
                self.train_losses.append(train_loss)
                self.val_losses.append(val_loss)
                self.track_tokens_seen.append(self.tokens_seen)
                logger.info("step %d: train %.3f, val %.3f, lr %.2e, "
                            "%.0f tok/s", self.global_step, train_loss,
                            val_loss, self.track_lrs[-1], tps)
                t_tokens, t_start = 0, time.perf_counter()
                excluded = 0.0

            if self.global_step % self.print_sample_iter == 0:
                t0 = time.perf_counter()
                self.generate_and_print_sample(start_context)
                excluded += time.perf_counter() - t0

    def train_model(self, files: Sequence[str], n_epochs: int,
                    start_context: str = "Every effort moves you"):
        """Causal-LM pretraining over raw-text files."""
        total_steps = self.loader.get_total_steps_epoch(
            list(files), eos_text=self.cfg.eos_text) * n_epochs
        self._setup(max(1, total_steps))
        logger.info("Total training steps: %d", total_steps)
        try:
            for epoch in range(n_epochs):
                for path in files:
                    train_ds, val_ds = self.loader.create_datasets_for_file(
                        path, eos_text=self.cfg.eos_text)
                    if self.loader.num_batches(train_ds) == 0:
                        logger.warning("File %s too small for one batch; "
                                       "skipping", path)
                        continue
                    self._run_epoch(
                        lambda e, ds=train_ds: self.loader.batches(
                            ds, shuffle=True, epoch=e),
                        lambda e, ds=val_ds: self.loader.batches(
                            ds, shuffle=False, epoch=e),
                        epoch, start_context)
        finally:
            self._flush_metrics()
        return self

    def export_final(self, filename: str = "model_pg_final.npz") -> str:
        """Final single-file parameter export (the JAX ``export_params``
        format)."""
        return export_params(os.path.join(self.output_dir, filename),
                             self.model)
