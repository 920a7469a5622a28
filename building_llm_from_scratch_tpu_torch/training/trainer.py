"""The training engine (port of the single-device core of the JAX
package's ``training/trainer.py``): pretraining (``train_model``) and
instruction finetuning (``finetune_model``), either on the whole model or
on a LoRA adapter over a frozen one.

Per-file epochs over shuffled fixed-shape batches, the warmup+cosine LR
over the precomputed total steps, evaluation every ``eval_freq`` steps on
at most ``EVAL_ITERS`` batches of each split, a greedy sample every
``print_sample_iter`` steps (and one before the first step), and the final
``.npz`` export. The step loop never waits on the device between cadence
points: per-step metrics stay device tensors until the evaluation cadence
fetches them. With LoRA the steps train through the merge, sampling
applies the adapter unmerged (``generate(lora=)``), ``export_final``
writes the merged weights and ``export_adapter`` the adapter artifact.

Train-state checkpoints (the JAX ``sharded-v1`` format, read by either
package) every ``save_ckpt_freq`` steps, with the data cursor (epoch, file,
next batch) in their metadata, pruned to ``keep_ckpts``; ``resume_from``
restores the state in place, keeps the original LR horizon and
fast-forwards the deterministic (seed, epoch) shuffle to the cursor, so a
resumed run's remaining steps are the unbroken run's. A ``stopper``
(``resilience.GracefulStopper``) ends the run at a step boundary with an
``interrupted`` checkpoint; a ``watchdog`` (``resilience.LossWatchdog``)
sees every step's loss when the metrics are fetched.

A precision ``policy`` (``training/precision.py``) and ``grad_accum``
microbatches go to the train step (``training/train_step.py``); with
the fp16 policy the metrics carry ``loss_scale`` and ``skipped``, and each
evaluation window logs its skipped steps.

Host/device overlap: with ``prefetch`` > 0 a worker thread
(``data/prefetch.Prefetcher``) builds the next batches and copies them to
the card on a side stream (``DeviceStager``), ``prefetch`` deep, after the
resume fast-forward; evaluation batches ride their own small prefetcher,
so the cadence never drains the training queue. Each window logs its
``prefetch_stall`` and ``prefetch_fill_ratio``. With ``async_ckpt`` the
periodic saves pay only the snapshot on the step loop and write on a
worker (``training/async_checkpoint.py``), pruning on commit; ``final``
and ``interrupted`` wait until durable. The prefetchers and the writer
close in a ``finally``.

Not ported yet: sharded plans, profiling, the stall detector and the
metrics sink (obs/).
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.data.instruct import format_input
from building_llm_from_scratch_tpu_torch.data.prefetch import (
    DeviceStager,
    Prefetcher,
)
from building_llm_from_scratch_tpu_torch.generate import (
    generate,
    text_to_token_ids,
    token_ids_to_text,
)
from building_llm_from_scratch_tpu_torch.models.lora import (
    count_lora_params,
    merge_lora,
    save_adapter,
)
from building_llm_from_scratch_tpu_torch.models.transformer import Transformer
from building_llm_from_scratch_tpu_torch.training.async_checkpoint import (
    AsyncCheckpointer,
)
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    checkpoint_metadata,
    export_params,
    save_checkpoint,
)
from building_llm_from_scratch_tpu_torch.training.optim import (
    AdamW,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu_torch.training.resilience import (
    PreemptionStop,
    prune_checkpoints,
)
from building_llm_from_scratch_tpu_torch.training.train_step import (
    checkpoint_tree,
    init_train_state,
    make_eval_step,
    make_train_step,
    restore_train_state,
)
from building_llm_from_scratch_tpu_torch.utils.io import read_json_file

logger = logging.getLogger(__name__)

#: batches of each split per evaluation (the JAX CLI's ``eval_iters``)
EVAL_ITERS = 5

#: the numpy dtype of each batch array on its way to the step
_BATCH_DTYPES = {"inputs": np.int64, "targets": np.int64,
                 "weights": np.float32}


class Trainer:
    """Drives pretraining (``train_model``) and instruction finetuning
    (``finetune_model``) over a file list: one model, one optimizer. With
    ``lora_params`` (an adapter tree, with ``lora_alpha`` and
    ``lora_rank``) the adapter is trained and the model stays frozen.
    ``resume_from`` names a train-state checkpoint to continue from;
    ``policy``, ``grad_accum``, ``prefetch`` and ``async_ckpt`` are the
    module docstring's."""

    def __init__(self, cfg: ModelConfig, model: Transformer, tokenizer, loader,
                 *, output_dir: str = "model_checkpoints",
                 peak_lr: float = 5e-4, initial_lr: float = 1e-5,
                 min_lr: float = 1e-6, warmup_steps: int = 10,
                 eval_freq: int = 10, print_sample_iter: int = 10,
                 seed: int = 123, lora_params: Optional[dict] = None,
                 lora_alpha: Optional[float] = None,
                 lora_rank: Optional[int] = None,
                 save_ckpt_freq: int = 100,
                 resume_from: Optional[str] = None, keep_ckpts: int = 0,
                 watchdog=None, stopper=None, policy=None,
                 grad_accum: int = 1, prefetch: int = 0,
                 async_ckpt: bool = False):
        if (lora_params is None) != (lora_rank is None):
            raise ValueError(
                "lora_params and lora_rank must be passed together "
                "(got one without the other)")
        if lora_params is not None and lora_alpha is None:
            raise ValueError("lora_alpha is required when using LoRA")
        self.lora_params = lora_params
        self.lora_alpha = lora_alpha
        self.lora_rank = lora_rank
        self.use_lora = lora_params is not None
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
        self.save_ckpt_freq = save_ckpt_freq
        self.resume_from = resume_from
        self.keep_ckpts = keep_ckpts
        self.watchdog = watchdog
        self.stopper = stopper
        self.policy = policy
        self.grad_accum = grad_accum
        self.prefetch = prefetch
        self._stager = DeviceStager(model.device)
        self._async_ckpt = AsyncCheckpointer() if async_ckpt else None
        #: prefetch stalls over the run (the windows' are in window_logs)
        self.prefetch_stall_total = 0
        #: (epoch, file_index, file, batch_index) of the next batch to
        #: train, written into checkpoint metadata; the restored one
        self._cursor: Optional[Dict[str, Any]] = None
        self._resume_cursor: Optional[Dict[str, Any]] = None
        self._schedule_horizon = 0
        self.preempted = False
        #: what each checkpoint save wrote (path, leaves, bytes, seconds)
        self.checkpoint_saves: List[Dict[str, Any]] = []
        #: the restore of a resumed run (path, step, seconds)
        self.restored: Optional[Dict[str, Any]] = None

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
        #: update_norm, lr, tokens; loss_scale and skipped with loss
        #: scaling), fetched at the evaluation cadence
        self.step_metrics: List[Dict[str, Any]] = []
        self._pending: List[tuple] = []
        #: one row per evaluation window: step, tokens_per_s, skipped
        #: steps and, with prefetch, prefetch_stall and prefetch_fill_ratio
        self.window_logs: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def _setup(self, total_steps: int) -> None:
        """Optimizer, schedule and steps once the total steps are known. On
        resume the checkpoint's schedule horizon is kept, so the LR follows
        the unbroken run's curve; it grows only when the requested steps
        overshoot it. A checkpoint with a data cursor is mid-run (the same
        plan runs again, so ``total_steps`` already counts the steps taken);
        one without (``final``) trains ``total_steps`` more."""
        prev_steps = prev_horizon = 0
        mid_run = False
        if self.resume_from is not None:
            meta = checkpoint_metadata(self.resume_from)
            ckpt_model = meta.get("model")
            if ckpt_model and ckpt_model != self.cfg.name:
                raise ValueError(
                    f"Checkpoint {self.resume_from} was written by model "
                    f"'{ckpt_model}' but this run builds '{self.cfg.name}' "
                    "— a stale checkpoint in a reused --output_dir? Pass "
                    "--resume off for a fresh start or point --resume_from "
                    "at a matching checkpoint.")
            prev_steps = int(meta.get("global_step", 0))
            prev_horizon = int(meta.get("schedule_horizon", 0))
            mid_run = meta.get("cursor") is not None
        horizon = max(prev_horizon,
                      total_steps if mid_run else total_steps + prev_steps)
        self._schedule_horizon = horizon
        h = self.opt_hparams
        self.lr_schedule = warmup_cosine_schedule(
            h["peak_lr"], h["initial_lr"], h["min_lr"], h["warmup_steps"],
            horizon)
        self.optimizer = AdamW(self.lr_schedule)
        if self.use_lora:
            self.state = init_train_state(self.lora_params, self.optimizer,
                                          self.seed, frozen=self.model,
                                          policy=self.policy)
        else:
            self.state = init_train_state(self.model, self.optimizer, self.seed,
                                          policy=self.policy)
        if self.resume_from is not None:
            t0 = time.perf_counter()
            restore_train_state(self.state, self.resume_from)
            if self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)
            self.global_step = int(meta.get("global_step", 0))
            self.tokens_seen = int(meta.get("tokens_seen", 0))
            # a mid-run checkpoint's cursor; the live cursor starts as it,
            # so a stop before the first step re-saves the same position
            self._resume_cursor = meta.get("cursor")
            self._cursor = self._resume_cursor
            self.restored = dict(path=self.resume_from, step=self.global_step,
                                 seconds=time.perf_counter() - t0)
            logger.info("Resumed from %s at step %d (%d tokens seen)%s",
                        self.resume_from, self.global_step, self.tokens_seen,
                        f", data cursor {self._resume_cursor}"
                        if self._resume_cursor else "")
        kw = dict(lora_alpha=self.lora_alpha, lora_rank=self.lora_rank,
                  policy=self.policy)
        self.train_step = make_train_step(self.cfg, self.optimizer,
                                          grad_accum=self.grad_accum, **kw)
        self.eval_step = make_eval_step(self.cfg, **kw)

    def _staged_item(self, arrays):
        """What a batch stream yields: (inputs, targets[, loss weights])
        numpy arrays staged for the model's device (``DeviceStager``), and
        the batch's token count."""
        staged = self._stager.stage(
            dict(zip(("inputs", "targets", "weights"), arrays)), _BATCH_DTYPES)
        return staged, int(np.prod(np.shape(arrays[0])))

    def _device_batch(self, arrays) -> Dict[str, torch.Tensor]:
        """(inputs, targets[, loss weights]) numpy arrays -> the step's
        batch on the model's device."""
        return self._staged_item(arrays)[0].ready()

    def _batch_stream(self, batches, depth: int, name: str):
        """``batches`` as (staged batch, tokens) items: through a
        prefetcher ``depth`` deep (returned too, for its counters and its
        close), or staged in the loop when ``depth`` is 0."""
        if depth == 0:
            return map(self._staged_item, batches), None
        pf = Prefetcher(batches, depth, place_fn=self._staged_item, name=name)
        return pf, pf

    # ------------------------------------------------------------------
    # evaluation / sampling
    # ------------------------------------------------------------------

    def calc_loss_loader(self, batches, num_batches: Optional[int] = None
                         ) -> float:
        """Mean eval loss over at most ``num_batches`` batches; with
        prefetch they ride their own prefetcher (at most 2 deep)."""
        stream, pf = self._batch_stream(
            itertools.islice(batches, num_batches),
            min(self.prefetch, 2), "eval-prefetch")
        try:
            losses = [float(self.eval_step(self.state, staged.ready()))
                      for staged, _ in stream]
        finally:
            if pf is not None:
                pf.close()
        return float(np.mean(losses)) if losses else float("nan")

    def evaluate_model(self, train_batches, val_batches):
        return (self.calc_loss_loader(train_batches, EVAL_ITERS),
                self.calc_loss_loader(val_batches, EVAL_ITERS))

    def _full_params(self) -> Dict[str, torch.Tensor]:
        """The model's flat parameters, with the adapter merged in a LoRA
        run."""
        params = self.model.flat_params()
        if self.use_lora:
            with torch.no_grad():
                return merge_lora(params, self.lora_params, self.lora_alpha,
                                  self.lora_rank)
        return params

    def generate_and_print_sample(self, start_context: str,
                                  max_new_tokens: int = 50) -> str:
        ids = text_to_token_ids(start_context, self.tokenizer)
        ids = ids[:, -self.cfg.context_length:]
        # with LoRA, merge-free: the adapter rides every projection
        # unmerged, as the serving engine applies it
        lora = (dict(lora=self.lora_params, lora_alpha=self.lora_alpha,
                     lora_rank=self.lora_rank) if self.use_lora else {})
        out = generate(self.model, ids, max_new_tokens=max_new_tokens,
                       context_size=self.cfg.context_length,
                       eos_id=self.cfg.eos_id, **lora)
        text = token_ids_to_text(out, self.tokenizer)
        logger.info("Sample: %s", text.replace("\n", " "))
        self.samples.append(text)
        return text

    # ------------------------------------------------------------------
    # core loop
    # ------------------------------------------------------------------

    def _flush_metrics(self, check_watchdog: bool = True) -> None:
        """Fetch the pending per-step device metrics as host floats; the
        watchdog sees each step's loss."""
        pending, self._pending = self._pending, []
        for step, m in pending:
            row = dict(step=step, loss=float(m["loss"]),
                       grad_norm=float(m["grad_norm"]),
                       update_norm=float(m["update_norm"]), lr=m["lr"],
                       tokens=m["tokens"])
            if "loss_scale" in m:
                row.update(loss_scale=m["loss_scale"], skipped=m["skipped"])
            self.step_metrics.append(row)
        if self.watchdog is not None and check_watchdog:
            for m in self.step_metrics[len(self.step_metrics) - len(pending):]:
                self.watchdog.observe(m["step"], m["loss"])

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, tag: str, cursor: Optional[Dict[str, Any]] = None,
                        prune_after: bool = False) -> str:
        """Write the train state as ``<output_dir>/model_pg_<tag>`` with the
        run's metadata (model, global_step, tokens_seen, the schedule
        horizon and, mid-run, the data cursor); with ``prune_after`` the
        oldest step checkpoints beyond ``keep_ckpts`` go. With
        ``async_ckpt`` the write is queued (its record gains the write's
        figures on commit, and the pruning waits for the commit); ``final``
        and ``interrupted`` wait until it is durable."""
        path = os.path.join(self.output_dir, f"model_pg_{tag}")
        metadata = {"global_step": self.global_step,
                    "tokens_seen": self.tokens_seen, "model": self.cfg.name,
                    "schedule_horizon": self._schedule_horizon}
        if cursor is not None:
            metadata["cursor"] = cursor
        prune = prune_after and self.keep_ckpts > 0
        record = dict(tag=tag, step=self.global_step)
        self.checkpoint_saves.append(record)
        tree = checkpoint_tree(self.state)
        if self._async_ckpt is None:
            record.update(save_checkpoint(path, tree, metadata))
            logger.info("Saved checkpoint %s (%d bytes in %.2f s)", path,
                        record["bytes"], record["seconds"])
            if prune:
                prune_checkpoints(self.output_dir, keep=self.keep_ckpts)
            return path

        def on_commit(info: Dict[str, Any]) -> None:
            record.update(info)
            if prune:
                prune_checkpoints(self.output_dir, keep=self.keep_ckpts)

        record["snapshot_s"] = self._async_ckpt.save(path, tree, metadata,
                                                     on_commit=on_commit)
        if tag in ("final", "interrupted"):
            self._async_ckpt.wait()
        return path

    def _resume_skip(self, epoch: int, file_index: int, path: str = ""):
        """(batches to skip, skip the whole file) of the resume fast-forward.
        The restored cursor names the next (epoch, file, batch) to train:
        earlier files are skipped, the cursor's file starts at its batch
        (the shuffle is deterministic in (seed, epoch)), later ones run
        whole. The cursor names its file, so a data dir whose files moved
        since the checkpoint is refused instead of resumed into the wrong
        file."""
        cur = self._resume_cursor
        if not cur:
            return 0, False
        ce = int(cur.get("epoch", 0))
        cf = int(cur.get("file_index", 0))
        if (epoch, file_index) < (ce, cf):
            return 0, True
        if (epoch, file_index) == (ce, cf):
            want = cur.get("file")
            have = os.path.basename(path) if path else ""
            if want and have and want != have:
                raise ValueError(
                    f"Resume cursor points at file '{want}' (position {cf}) "
                    f"but the discovered file list now has '{have}' there — "
                    "data_dir contents changed since the checkpoint. Restore "
                    "the original file list or restart with --resume off.")
            return int(cur.get("batch_index", 0)), False
        return 0, False

    def _run_epoch(self, train_batches_fn: Callable[..., Any],
                   val_batches_fn: Callable[[int], Any], epoch: int,
                   start_context: str, file_index: int = 0,
                   file_name: str = "", skip_batches: int = 0) -> None:
        """One pass over one file's batches with the cadence work;
        ``skip_batches`` starts a resumed run at its cursor (the stream is
        cut there before a prefetcher wraps it)."""
        if self.global_step == 0 and not self.samples:
            self.generate_and_print_sample(start_context)
        stream, prefetcher = self._batch_stream(
            train_batches_fn(epoch, skip_batches), self.prefetch,
            "train-prefetch")
        try:
            self._epoch_steps(stream, prefetcher, train_batches_fn,
                              val_batches_fn, epoch, start_context,
                              file_index, file_name, skip_batches)
        finally:
            if prefetcher is not None:
                self.prefetch_stall_total += prefetcher.stalls
                prefetcher.close()

    def _window_row(self, tps: float, skipped: int, prefetcher,
                    base: Optional[dict]) -> Dict[str, Any]:
        """The evaluation window's log row; the prefetch fields are deltas
        of the prefetcher's counters since ``base``."""
        row = dict(step=self.global_step, tokens_per_s=tps, skipped=skipped)
        if prefetcher is not None:
            c = prefetcher.counters()
            pops = c["pops"] - base["pops"]
            row["prefetch_stall"] = c["stalls"] - base["stalls"]
            row["prefetch_fill_ratio"] = (
                (c["fill_sum"] - base["fill_sum"]) / pops / prefetcher.depth
                if pops else None)
        return row

    def _epoch_steps(self, stream, prefetcher, train_batches_fn,
                     val_batches_fn, epoch: int, start_context: str,
                     file_index: int, file_name: str,
                     skip_batches: int) -> None:
        """The step loop of ``_run_epoch`` over (staged batch, tokens)
        items."""
        t_tokens, t_start, excluded = 0, time.perf_counter(), 0.0
        skipped = 0
        base = prefetcher.counters() if prefetcher is not None else None
        batch_in_file = skip_batches
        for staged, n_tok in stream:
            self.state, metrics = self.train_step(self.state, staged.ready())
            skipped += metrics.get("skipped", 0)
            self.global_step += 1
            batch_in_file += 1
            self._cursor = {"epoch": epoch, "file_index": file_index,
                            "file": file_name, "batch_index": batch_in_file}
            self.tokens_seen += n_tok
            t_tokens += n_tok
            self.track_lrs.append(metrics["lr"])
            self._pending.append((self.global_step, metrics))

            if self.global_step % self.eval_freq == 0:
                self._flush_metrics()      # waits for the step's device work
                tps = t_tokens / max(time.perf_counter() - t_start - excluded,
                                     1e-9)
                self.throughput_tokens_per_s.append(tps)
                row = self._window_row(tps, skipped, prefetcher, base)
                self.window_logs.append(row)
                train_loss, val_loss = self.evaluate_model(
                    train_batches_fn(epoch), val_batches_fn(epoch))
                self.train_losses.append(train_loss)
                self.val_losses.append(val_loss)
                self.track_tokens_seen.append(self.tokens_seen)
                logger.info("step %d: train %.3f, val %.3f, lr %.2e, "
                            "%.0f tok/s%s%s", self.global_step, train_loss,
                            val_loss, self.track_lrs[-1], tps,
                            f", {skipped} skipped steps (loss scale "
                            f"{metrics['loss_scale']:g})"
                            if "loss_scale" in metrics else "",
                            f", {row['prefetch_stall']} prefetch stalls, "
                            f"fill {row['prefetch_fill_ratio']}"
                            if prefetcher is not None else "")
                t_tokens, t_start = 0, time.perf_counter()
                excluded, skipped = 0.0, 0
                if prefetcher is not None:
                    base = prefetcher.counters()

            if self.global_step % self.print_sample_iter == 0:
                t0 = time.perf_counter()
                self.generate_and_print_sample(start_context)
                excluded += time.perf_counter() - t0

            if self.global_step % self.save_ckpt_freq == 0:
                t0 = time.perf_counter()
                self.save_checkpoint(str(self.global_step), cursor=self._cursor,
                                     prune_after=True)
                excluded += time.perf_counter() - t0

            if self.stopper is not None and self.stopper.should_stop():
                logger.warning("Graceful stop requested: writing checkpoint "
                               "at step %d and exiting.", self.global_step)
                self.save_checkpoint("interrupted", cursor=self._cursor)
                self.preempted = True
                raise PreemptionStop

    def _run_files(self, files: Sequence[str], n_epochs: int, datasets,
                   what: str) -> None:
        """The epochs over ``files``: ``datasets(path)`` gives (train, val,
        sample prompt) of a file; a resumed run skips to its cursor. A
        graceful stop returns; an abort (KeyboardInterrupt) writes an
        ``interrupted`` checkpoint and re-raises."""
        try:
            for epoch in range(n_epochs):
                for file_index, path in enumerate(files):
                    skip, skip_file = self._resume_skip(epoch, file_index, path)
                    if skip_file:
                        continue
                    train_ds, val_ds, start_context = datasets(path)
                    if self.loader.num_batches(train_ds) == 0:
                        logger.warning("File %s too small for one batch; "
                                       "skipping", path)
                        continue
                    self._run_epoch(
                        lambda e, start=0, ds=train_ds: self.loader.batches(
                            ds, shuffle=True, epoch=e, start=start),
                        lambda e, ds=val_ds: self.loader.batches(
                            ds, shuffle=False, epoch=e),
                        epoch, start_context, file_index=file_index,
                        file_name=os.path.basename(path), skip_batches=skip)
        except PreemptionStop:
            logger.warning("%s stopped gracefully at step %d; relaunch with "
                           "--resume auto to continue.", what, self.global_step)
        except KeyboardInterrupt:
            # the abort path (no stopper, or a second SIGINT): the cursor may
            # trail the state by one batch if the interrupt lands between
            # the step and the cursor update
            self.save_checkpoint("interrupted", cursor=self._cursor)
            raise
        finally:
            # no watchdog here: raising in finally would mask the exception
            # in flight
            self._flush_metrics(check_watchdog=False)
            if self._async_ckpt is not None:
                self._async_ckpt.close()

    def train_model(self, files: Sequence[str], n_epochs: int,
                    start_context: str = "Every effort moves you"):
        """Causal-LM pretraining over raw-text files."""
        total_steps = self.loader.get_total_steps_epoch(
            list(files), eos_text=self.cfg.eos_text) * n_epochs
        self._setup(max(1, total_steps))
        logger.info("Total training steps: %d", total_steps)

        def datasets(path):
            train_ds, val_ds = self.loader.create_datasets_for_file(
                path, eos_text=self.cfg.eos_text)
            return train_ds, val_ds, start_context

        self._run_files(files, n_epochs, datasets, "Training")
        return self

    def finetune_model(self, files: Sequence[str], n_epochs: int):
        """Instruction finetuning over Alpaca-format ``.json`` files; each
        file's sample prompt is its validation split's first record (the
        train split's when the validation split is empty) through the
        Alpaca template."""
        total_steps = self.loader.get_total_steps_epoch(list(files)) * n_epochs
        self._setup(max(1, total_steps))
        logger.info("Total finetuning steps: %d", total_steps)

        def datasets(path):
            train_ds, val_ds = self.loader.create_datasets(read_json_file(path))
            entry = val_ds.data[0] if len(val_ds) > 0 else (
                train_ds.data[0] if len(train_ds) > 0 else None)
            return train_ds, val_ds, entry and format_input(entry)

        self._run_files(files, n_epochs, datasets, "Finetuning")
        return self

    def export_final(self, filename: str = "model_pg_final.npz") -> str:
        """Final single-file parameter export (the JAX ``export_params``
        format); a LoRA run writes the merged weights."""
        return export_params(os.path.join(self.output_dir, filename),
                             self._full_params())

    def export_adapter(self, path: str) -> str:
        """``--save_adapter``: the trained adapter as a standalone artifact
        (``models.lora.save_adapter``: rank, alpha and the base config's
        fingerprint) that ``--serve_adapters`` loads."""
        if not self.use_lora:
            raise ValueError("export_adapter needs a LoRA run "
                             "(no adapter tree to export)")
        save_adapter(path, self.lora_params, rank=self.lora_rank,
                     alpha=self.lora_alpha, cfg=self.cfg)
        logger.info("Exported LoRA adapter to %s (rank %d, alpha %s, %s "
                    "parameters).", path, self.lora_rank, self.lora_alpha,
                    f"{count_lora_params(self.lora_params):,}")
        return path
