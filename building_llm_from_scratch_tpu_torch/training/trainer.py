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

A mesh ``plan`` (``parallel.MeshPlan``: dp, fsdp, zero1, tp or tp_fsdp
over a (data, seq, model) mesh, one process per device) places the state
(``init_train_state(plan=)``) and takes the sharded step
(``make_sharded_train_step``); the loader hands each data rank its rows of
the global batch (its seq and model ranks share them), so ``tokens_seen``
counts the data rank's share, as in the JAX trainer, while the cursor (a
global batch index) is the same on every rank. A ``PipelinePlan``
(``--shard_mode pp``) takes the pipelined steps (``make_pp_train_step`` /
``make_pp_eval_step``) on the global batch, which every rank loads, and
refuses ``--grad_accum`` (its microbatches are ``--pp_micro``). Evaluation losses are the global batches' (all-reduced sums).
Samples, the final export and the adapter export gather the whole masters
on every rank (a collective) before rank 0 alone generates or writes;
checkpoints are written shard by shard by their owners (rank 0 commits
and prunes), and with several ranks saves are synchronous.

Telemetry (``obs/``, the JAX trainer's): a ``StepTimeline`` times each
window's ``data_wait`` (the batch pop), ``dispatch`` (the step's launch),
``host_fetch`` (the cadence's fetch, where the device catch-up shows) and
the ``eval`` / ``sample`` / ``checkpoint`` work left out of tok/s. Every
``log_every`` steps (``eval_freq`` when 0) the process-wide metrics sink
gets a ``metrics`` row: ``lr``, ``tokens_seen``, ``tok_s``, ``mfu`` (against
the card's peak for the compute dtype; None on the CPU), ``step_time_s``,
the timeline's seconds, ``steps_in_window``, the prefetch counters, the
global ``grad_norm`` / ``update_norm`` from the health bundle, the memory
ledger's ``hbm_bytes_in_use`` / ``hbm_peak_bytes`` / ``host_rss_bytes``
(its ``memory_snapshot`` event beside) and, at an evaluation,
``train_loss`` / ``val_loss``; then a ``health`` row (per-layer-group
arrays). The steps' health bundles stay device tensors until that fetch;
the watchdog's halt names the layer group of the step that tripped it.
``stall`` (``obs/stall.StallDetector``) gets a heartbeat each step.
``profile_dir`` records the first ``profile_steps`` steps (and a fresh
run's warm-up sample before them) with
``torch.profiler`` (CPU, and CUDA kernels on the card) and writes them as
Chrome trace JSON ``<profile_dir>/trace_rank<r>.json``, the timeline's
spans and the step's ``forward`` / ``backward`` / ``optimizer`` regions
among its annotations; on the card a trace without kernel events raises.
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
from building_llm_from_scratch_tpu_torch.obs.health import (
    describe_health,
    fetch_health,
    group_names,
    health_summary_line,
    nonfinite_group_name,
)
from building_llm_from_scratch_tpu_torch.obs.memory import (
    MemoryLedger,
    pytree_nbytes,
)
from building_llm_from_scratch_tpu_torch.obs.metrics import get_metrics
from building_llm_from_scratch_tpu_torch.obs.mfu import compute_mfu, format_mfu
from building_llm_from_scratch_tpu_torch.obs.timeline import (
    StepTimeline,
    window_stats,
)
from building_llm_from_scratch_tpu_torch.parallel import collectives
from building_llm_from_scratch_tpu_torch.parallel.collectives import (
    is_coordinator,
)
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
    checkpoint_layout,
    checkpoint_tree,
    gather_whole,
    init_train_state,
    make_eval_step,
    make_pp_eval_step,
    make_pp_train_step,
    make_sharded_train_step,
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
    ``policy``, ``grad_accum``, ``prefetch``, ``async_ckpt``, ``plan``,
    ``log_every``, ``stall``, ``profile_dir`` and ``profile_steps`` are the
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
                 async_ckpt: bool = False, plan=None, log_every: int = 0,
                 stall=None, profile_dir: Optional[str] = None,
                 profile_steps: int = 10):
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
        self.plan = plan
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
        self.log_every = log_every
        self.stall = stall
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiler = None
        self._profile_stop_at = 0
        #: the exported profiler trace (after --profile's steps)
        self.profile_trace: Optional[str] = None
        self.timeline = StepTimeline(on_step=self._profiler_step)
        #: per-layer-group health: the group names, the steps' device
        #: bundles until the cadence fetch, the fetched ones by step
        self._health_names: List[str] = []
        self._pending_health: List[tuple] = []
        self._health_by_step: Dict[int, Dict[str, Any]] = {}
        self._last_health: Optional[Dict[str, Any]] = None
        self._ctx_health: Optional[Dict[str, Any]] = None
        self._memory_ledger: Optional[MemoryLedger] = None
        #: the logging windows' training seconds, summed over the run
        self.step_seconds_total = 0.0

        self.state = None
        self.global_step = 0
        self.tokens_seen = 0
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self.track_lrs: List[float] = []
        self.track_tokens_seen: List[int] = []
        #: training tokens/s of each evaluation window (sample time left out)
        self.throughput_tokens_per_s: List[float] = []
        #: sample texts, in order (the warm-up sample first; rank 0's)
        self.samples: List[str] = []
        self._warmed_up = False
        #: per-step metrics as host floats (step, loss, grad_norm,
        #: update_norm, lr, tokens; loss_scale and skipped with loss
        #: scaling), fetched at the evaluation cadence
        self.step_metrics: List[Dict[str, Any]] = []
        self._pending: List[tuple] = []
        #: one row per logging window: step, tokens_per_s, skipped steps
        #: and, with prefetch, prefetch_stall and prefetch_fill_ratio
        self.window_logs: List[Dict[str, Any]] = []

    @property
    def metrics_sink(self):
        """The process-wide metrics sink (resolved per call, so a later
        ``configure_metrics`` wins; a no-op sink when unconfigured)."""
        return get_metrics()

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
                                          policy=self.policy, plan=self.plan)
        else:
            self.state = init_train_state(self.model, self.optimizer, self.seed,
                                          policy=self.policy, plan=self.plan)
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
        if self.plan is not None and self.plan.shard_mode == "pp":
            if self.grad_accum > 1:
                raise ValueError("--grad_accum composes with the GSPMD step only: pp "
                                 "has its own microbatching (--pp_micro)")
            self.train_step = make_pp_train_step(self.cfg, self.optimizer, self.plan, **kw)
            self.eval_step = make_pp_eval_step(self.cfg, self.plan, **kw)
            self._finalize_steps()
            return
        if self.plan is None:
            self.train_step = make_train_step(self.cfg, self.optimizer,
                                              grad_accum=self.grad_accum, **kw)
        else:
            self.train_step = make_sharded_train_step(
                self.cfg, self.optimizer, self.plan,
                grad_accum=self.grad_accum, **kw)
        self.eval_step = make_eval_step(self.cfg, plan=self.plan, **kw)
        self._finalize_steps()

    def _finalize_steps(self) -> None:
        """The health bundle's group names (the whole model's layers under
        pp) and the watchdog's which-layer context."""
        self._health_names = group_names(self.state.params,
                                         n_layers=self.cfg.n_layers)
        if self.watchdog is not None and self.watchdog.context_fn is None:
            self.watchdog.context_fn = self._watchdog_context

    def _watchdog_context(self) -> Dict[str, Any]:
        """The health digest of the step whose loss tripped the watchdog
        (else the latest fetched)."""
        fetched = (self._ctx_health if self._ctx_health is not None
                   else self._last_health)
        if fetched is None or not self._health_names:
            return {}
        return describe_health(self._health_names, fetched)

    def _compute_dtype(self) -> str:
        return self.policy.compute_dtype if self.policy is not None else self.cfg.dtype

    def _mfu_devices(self) -> int:
        """The cards whose work this process's tokens/s counts: its data
        rank's replicas (seq and model ranks share its rows), every rank
        under pp (each counts the global batch), one without a plan."""
        if self.plan is None:
            return 1
        world = collectives.world()
        return world if self.plan.shard_mode == "pp" else world // self.plan.n_data

    def _build_memory_ledger(self) -> MemoryLedger:
        """The trainer's ledger: the trainable masters (and a LoRA run's
        frozen base), the Adam moments, host RSS."""
        ledger = MemoryLedger(source="trainer", device=self.model.device)
        ledger.register("model_params", lambda: (
            pytree_nbytes(self.state.params)
            + (pytree_nbytes(self.state.model.stacked) if self.use_lora else 0)))
        ledger.register("optimizer_state", lambda: pytree_nbytes(
            [self.state.opt_state.mu, self.state.opt_state.nu]))
        ledger.track_host_rss()
        return ledger

    # ------------------------------------------------------------------
    # the profiler (--profile)
    # ------------------------------------------------------------------

    def _start_profiler(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.start()
        self._profile_stop_at = self.global_step + self.profile_steps

    def _profiler_step(self) -> None:
        if self._profiler is not None:
            self._profiler.step()

    def _stop_profiler(self) -> None:
        """Stop the trace and write it as Chrome trace JSON; on the card a
        trace without one kernel event is an error."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        if self.model.device.type == "cuda":
            # the last steps' kernels finish inside the trace
            torch.cuda.synchronize(self.model.device)
        prof.stop()
        self.profile_dir, out_dir = None, self.profile_dir
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace_rank{collectives.rank()}.json")
        prof.export_chrome_trace(path)
        self.profile_trace = path
        if self.model.device.type == "cuda":
            import json

            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            if not any(e.get("cat") == "kernel" for e in events):
                raise RuntimeError(f"--profile: the trace {path} holds no CUDA "
                                   "kernel event (the profiler saw no device "
                                   "activity)")
        logger.info("Profiler trace of %d steps written to %s",
                    self.profile_steps, path)

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

    def _gather_masters(self) -> None:
        """Under fsdp and tp, the whole masters gathered into the model (and
        the adapter) on every rank: a collective that every rank runs
        before rank 0 samples or writes. A no-op otherwise."""
        if self.state is not None:
            gather_whole(self.state)

    def _full_params(self) -> Dict[str, torch.Tensor]:
        """The model's flat parameters, with the adapter merged in a LoRA
        run."""
        self._gather_masters()
        params = self.model.flat_params()
        if self.use_lora:
            with torch.no_grad():
                return merge_lora(params, self.lora_params, self.lora_alpha,
                                  self.lora_rank)
        return params

    def generate_and_print_sample(self, start_context: str,
                                  max_new_tokens: int = 50) -> Optional[str]:
        """A greedy sample from ``start_context``, logged and kept in
        ``samples``; under a plan every rank gathers, rank 0 alone
        generates (the others return None)."""
        self._gather_masters()
        if not is_coordinator():
            return None
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
        """Fetch the pending per-step device metrics as host floats and the
        pending health bundles as host arrays (kept by step, so the
        watchdog's context names the layer at the step that tripped it);
        the watchdog sees each step's loss."""
        pending, self._pending = self._pending, []
        for step, m in pending:
            row = dict(step=step, loss=float(m["loss"]),
                       grad_norm=float(m["grad_norm"]),
                       update_norm=float(m["update_norm"]), lr=m["lr"],
                       tokens=m["tokens"])
            if "loss_scale" in m:
                row.update(loss_scale=m["loss_scale"], skipped=m["skipped"])
            self.step_metrics.append(row)
        if self._pending_health:
            health, self._pending_health = self._pending_health, []
            self._health_by_step = {step: fetch_health(h) for step, h in health}
            self._last_health = self._health_by_step[health[-1][0]]
        if self.watchdog is not None and check_watchdog:
            try:
                for m in self.step_metrics[len(self.step_metrics) - len(pending):]:
                    self._ctx_health = self._health_by_step.get(m["step"])
                    self.watchdog.observe(m["step"], m["loss"])
            finally:
                self._ctx_health = None

    def _emit_health_row(self) -> None:
        """One ``health`` row a logging window: the group names and the
        arrays of the window's last step."""
        h = self._last_health
        if h is None or not self._health_names:
            return
        self.metrics_sink.log_health(
            self.global_step, self._health_names,
            grad_norm=[round(float(x), 8) for x in h["grad_norm"]],
            param_norm=[round(float(x), 8) for x in h["param_norm"]],
            update_norm=[round(float(x), 8) for x in h["update_norm"]],
            update_ratio=[round(float(x), 10) for x in h["update_ratio"]],
            first_nonfinite=nonfinite_group_name(self._health_names, h))

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
        # rank 0 prunes, after the save's commit barrier
        prune = prune_after and self.keep_ckpts > 0 and is_coordinator()
        record = dict(tag=tag, step=self.global_step)
        self.checkpoint_saves.append(record)
        tree, layout = checkpoint_tree(self.state), checkpoint_layout(self.state)
        if self._async_ckpt is None:
            record.update(save_checkpoint(path, tree, metadata, layout))
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
                                                     on_commit=on_commit,
                                                     layout=layout)
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
        if self.profile_dir is not None and self._profiler is None:
            # armed before the warm-up sample: the tracer's first moments
            # (CUPTI has been seen to miss a kernel right after it starts)
            # fall on the sample, not on the first step
            self._start_profiler()
        if self.global_step == 0 and not self._warmed_up:
            # the same decision on every rank (the sample gathers)
            self._warmed_up = True
            with self.timeline.span("sample"):
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
        """The logging window's row of ``window_logs``; the prefetch fields
        are deltas of the prefetcher's counters since ``base``."""
        row = dict(step=self.global_step, tokens_per_s=tps, skipped=skipped)
        if prefetcher is not None:
            c = prefetcher.counters()
            pops = c["pops"] - base["pops"]
            row["prefetch_stall"] = c["stalls"] - base["stalls"]
            row["prefetch_fill_ratio"] = (
                (c["fill_sum"] - base["fill_sum"]) / pops / prefetcher.depth
                if pops else None)
        return row

    def _metrics_row(self, window: dict, stats: dict, tps: float, mfu,
                     wrow: dict, prefetcher) -> Dict[str, Any]:
        """The window's ``metrics`` row (the JAX trainer's keys)."""
        row = {"lr": self.track_lrs[-1] if self.track_lrs else None,
               "tokens_seen": self.tokens_seen, "tok_s": round(tps, 1),
               "mfu": mfu, "step_time_s": stats["step_time_s"],
               "data_wait_s": round(window.get("data_wait", 0.0), 6),
               "dispatch_s": round(window.get("dispatch", 0.0), 6),
               "host_fetch_s": round(window.get("host_fetch", 0.0), 6),
               "steps_in_window": int(window.get("steps", 0))}
        if prefetcher is not None:
            row["prefetch_stall"] = wrow["prefetch_stall"]
            row["prefetch_qdepth"] = prefetcher.qsize()
            if wrow["prefetch_fill_ratio"] is not None:
                row["prefetch_fill_ratio"] = round(wrow["prefetch_fill_ratio"], 3)
        if self._last_health is not None:
            # the global norms from the fetched bundle: no other fetch
            for key in ("grad_norm", "update_norm"):
                row[key] = round(float(np.sqrt(np.sum(np.asarray(
                    self._last_health[key], np.float64) ** 2))), 8)
        if self._memory_ledger is None:
            self._memory_ledger = self._build_memory_ledger()
        self._memory_ledger.observe(self.global_step)
        row.update(self._memory_ledger.legacy_row())
        return row

    def _epoch_steps(self, stream, prefetcher, train_batches_fn,
                     val_batches_fn, epoch: int, start_context: str,
                     file_index: int, file_name: str,
                     skip_batches: int) -> None:
        """The step loop of ``_run_epoch`` over (staged batch, tokens)
        items, with the cadence work (module docstring)."""
        # segments from outside any window (the warm-up sample, the last
        # file's trailing cadence work) leave the window opening here
        self.timeline.drain()
        t_tokens, t_start = 0, time.perf_counter()
        log_cadence = self.log_every if self.log_every > 0 else self.eval_freq
        skipped = 0
        base = prefetcher.counters() if prefetcher is not None else None
        batch_in_file = skip_batches
        items = iter(stream)
        while True:
            with self.timeline.span("data_wait"):
                item = next(items, None)
                batch = item[0].ready() if item is not None else None
            if item is None:
                break
            n_tok = item[1]
            with self.timeline.step_span(self.global_step + 1):
                self.state, metrics = self.train_step(self.state, batch)
            skipped += metrics.get("skipped", 0)
            self.global_step += 1
            batch_in_file += 1
            self._cursor = {"epoch": epoch, "file_index": file_index,
                            "file": file_name, "batch_index": batch_in_file}
            self.tokens_seen += n_tok
            t_tokens += n_tok
            self.track_lrs.append(metrics["lr"])
            health = metrics.pop("health", None)
            if health is not None:
                self._pending_health.append((self.global_step, health))
            self._pending.append((self.global_step, metrics))
            if self._profiler is not None and self.global_step >= self._profile_stop_at:
                self._stop_profiler()

            at_eval = self.global_step % self.eval_freq == 0
            if at_eval or self.global_step % log_cadence == 0:
                # the fetch waits for the last launched step: the window
                # measures execution, the catch-up landing in host_fetch
                with self.timeline.span("host_fetch"):
                    self._flush_metrics()
                elapsed = time.perf_counter() - t_start
                window = self.timeline.drain()
                stats = window_stats(window, elapsed, t_tokens)
                tps = stats["tok_s"]
                self.throughput_tokens_per_s.append(tps)
                self.step_seconds_total += stats["step_seconds"]
                # the window reopens here: the evaluation below, and the
                # sample and checkpoint after it, land in left-out segments
                t_tokens, t_start = 0, time.perf_counter()
                mfu = compute_mfu(tps, self.cfg, n_devices=self._mfu_devices(),
                                  device=self.model.device,
                                  dtype=self._compute_dtype())
                wrow = self._window_row(tps, skipped, prefetcher, base)
                self.window_logs.append(wrow)
                row = self._metrics_row(window, stats, tps, mfu, wrow, prefetcher)
                scaled = (f", {skipped} skipped steps (loss scale "
                          f"{metrics['loss_scale']:g})"
                          if "loss_scale" in metrics else "")
                stalls = (f", {wrow['prefetch_stall']} prefetch stalls, fill "
                          f"{wrow['prefetch_fill_ratio']}"
                          if prefetcher is not None else "")
                if at_eval:
                    with self.timeline.span("eval"):
                        train_loss, val_loss = self.evaluate_model(
                            train_batches_fn(epoch), val_batches_fn(epoch))
                    self.train_losses.append(train_loss)
                    self.val_losses.append(val_loss)
                    self.track_tokens_seen.append(self.tokens_seen)
                    row.update(train_loss=train_loss, val_loss=val_loss)
                    logger.info("step %d: train %.3f, val %.3f, lr %.2e, "
                                "%.0f tok/s, %s%s%s", self.global_step,
                                train_loss, val_loss, self.track_lrs[-1], tps,
                                format_mfu(mfu), scaled, stalls)
                    if self._last_health is not None:
                        logger.info("%s", health_summary_line(
                            self._health_names, self._last_health))
                else:
                    logger.info("step %d: lr %.2e, %.0f tok/s, %s, step %.1fms "
                                "(data_wait %.1fms)%s%s", self.global_step,
                                self.track_lrs[-1], tps, format_mfu(mfu),
                                1e3 * (stats["step_time_s"] or 0.0),
                                1e3 * window.get("data_wait", 0.0), scaled, stalls)
                self.metrics_sink.log_metrics(self.global_step, **row)
                self._emit_health_row()
                skipped = 0
                if prefetcher is not None:
                    base = prefetcher.counters()

            if self.global_step % self.print_sample_iter == 0:
                with self.timeline.span("sample"):
                    self.generate_and_print_sample(start_context)

            if self.global_step % self.save_ckpt_freq == 0:
                with self.timeline.span("checkpoint"):
                    self.save_checkpoint(str(self.global_step), cursor=self._cursor,
                                         prune_after=True)

            if self.stopper is not None and self.stopper.should_stop():
                logger.warning("Graceful stop requested: writing checkpoint "
                               "at step %d and exiting.", self.global_step)
                self.metrics_sink.event("preemption_stop", step=self.global_step,
                                        tokens_seen=self.tokens_seen)
                with self.timeline.span("checkpoint"):
                    self.save_checkpoint("interrupted", cursor=self._cursor)
                self.preempted = True
                raise PreemptionStop

            if self.stall is not None:
                # one heartbeat a step: a loop wedged anywhere (a
                # collective, the data pipeline, a fetch) stops beating
                self.stall.notify_step()

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
            if self._profiler is not None:
                self._stop_profiler()

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
        format); a LoRA run writes the merged weights. Under a plan every
        rank gathers and rank 0 writes."""
        path = os.path.join(self.output_dir, filename)
        params = self._full_params()
        if is_coordinator():
            export_params(path, params)
        return path

    def export_adapter(self, path: str) -> str:
        """``--save_adapter``: the trained adapter as a standalone artifact
        (``models.lora.save_adapter``: rank, alpha and the base config's
        fingerprint) that ``--serve_adapters`` loads."""
        if not self.use_lora:
            raise ValueError("export_adapter needs a LoRA run "
                             "(no adapter tree to export)")
        self._gather_masters()
        if not is_coordinator():
            return path
        save_adapter(path, self.lora_params, rank=self.lora_rank,
                     alpha=self.lora_alpha, cfg=self.cfg)
        logger.info("Exported LoRA adapter to %s (rank %d, alpha %s, %s "
                    "parameters).", path, self.lora_rank, self.lora_alpha,
                    f"{count_lora_params(self.lora_params):,}")
        return path
