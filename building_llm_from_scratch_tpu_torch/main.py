"""Entry point: ``python -m building_llm_from_scratch_tpu_torch --mode train``
(pretraining, or instruction finetuning with ``--finetune --dataset
alpaca``, optionally ``--use_lora``) or ``--mode serve``.

Training follows the JAX ``main``: seed, components (config, model,
tokenizer, adapter, precision policy), training files (``.txt``, or
``.json`` Alpaca records with ``--finetune``), loader, the resume choice
(``--resume auto`` finds the latest valid checkpoint in ``--output_dir``),
the loss watchdog (off under the fp16 policy, whose loss scaling skips
non-finite steps itself), the trainer (with a warm-up sample before a
fresh run's first step), training or finetuning under a SIGTERM/SIGINT
handler, the loss plot ``losses.pdf``, peak device memory, the ``final``
train-state checkpoint, the final ``.npz`` export (merged weights in a
LoRA run) and, with ``--save_adapter``, the adapter artifact. A run
stopped by a signal has written its ``interrupted`` checkpoint; it skips
the plot, the final checkpoint and exports and returns normally (exit 0),
and the same command resumes it. Without matplotlib the run logs one
warning and goes on without the plot. Telemetry: the metrics sink
(``--metrics_jsonl``) is configured before the build and gets its header
(run metadata, the mesh) once the components exist; the trainer writes
its cadence rows every ``--log_every`` steps; ``--stall_timeout`` runs the
flight recorder around training; ``--profile`` traces the first
``--profile_steps`` steps into ``<output_dir>/profile``; a run that ends
normally emits ``run_complete`` and logs the device memory.

``--run_type multi_chip`` (``--shard_mode dp|fsdp|zero1|tp|tp_fsdp|pp``,
``--tp``, ``--sp``, ``--pp``, ``--pp_micro``) trains with one
process per device, as the reference's ``mp.spawn`` did and as the JAX
mesh spans every local device: under torchrun's environment (``RANK``,
``WORLD_SIZE``, ...) the process joins that group; otherwise one process
is started per visible card (none extra with one card, or on the CPU,
where the run is one rank). The group forms first (NCCL on ``cuda``, gloo
on ``cpu``; ``parallel.initialize_distributed``), each rank takes
``cuda:<local rank>``, rank 0 makes the output directory before a
barrier, the loaders hand each data rank its rows (the seq and model ranks
of a data index share them; under pp every rank the same global rows), and
only rank 0 logs,
samples and draws ``losses.pdf``; checkpoints and exports are collective.
A caller that already formed a group (tests, chip_smoke) keeps it.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional

import torch

from building_llm_from_scratch_tpu_torch.args import get_args

logger = logging.getLogger("building_llm_from_scratch_tpu_torch.main")


def run_train(args):
    """Pretrain or finetune from the parsed flags; returns the Trainer (its
    loss history, samples, model and adapter)."""
    from building_llm_from_scratch_tpu_torch.build_components import (
        build_components,
    )
    from building_llm_from_scratch_tpu_torch.data.instruct import InstructLoader
    from building_llm_from_scratch_tpu_torch.data.pretrain import PretrainLoader
    from building_llm_from_scratch_tpu_torch.device import resolve_device
    from building_llm_from_scratch_tpu_torch.obs.metrics import (
        configure_metrics,
        emit_event,
        run_metadata,
    )
    from building_llm_from_scratch_tpu_torch.obs.stall import StallDetector
    from building_llm_from_scratch_tpu_torch.parallel import collectives
    from building_llm_from_scratch_tpu_torch.parallel.mesh import rank_device
    from building_llm_from_scratch_tpu_torch.training.resilience import (
        GracefulStopper,
        LossWatchdog,
        resolve_resume_agreed,
    )
    from building_llm_from_scratch_tpu_torch.training.trainer import Trainer
    from building_llm_from_scratch_tpu_torch.utils.io import (
        discover_training_files,
    )
    from building_llm_from_scratch_tpu_torch.utils.memory import (
        log_device_memory,
    )
    from building_llm_from_scratch_tpu_torch.utils.seeding import set_seed

    device = resolve_device(args.device)
    if args.run_type == "multi_chip":
        device = rank_device(device)
    set_seed(args.seed, device)
    # the sink first (events of the build wait for the header), the header
    # once the components and the mesh exist
    sink = configure_metrics(args.metrics_jsonl)
    comps = build_components(args, device)
    cfg = comps.cfg
    sink.write_header(**run_metadata(args, cfg, plan=comps.plan))

    txt_files, json_files = discover_training_files(args.data_dir)
    files = json_files if args.finetune else txt_files
    if not files:
        raise FileNotFoundError("No training files found in specified directory.")
    logger.info("Total training files detected: %d", len(files))
    # each data rank takes its rows; the seq and model ranks of one data
    # index share them. Under pp every rank takes the same global rows: the
    # schedule cuts each data column's rows out of every microbatch
    plan = comps.plan
    if plan is not None and plan.shard_mode == "pp":
        shard = dict(process_index=0, process_count=1)
    else:
        shard = dict(process_index=plan.data_rank if plan else collectives.rank(),
                     process_count=plan.n_data if plan else collectives.world())
    loader_kwargs = dict(batch_size=args.batch_size,
                         max_length=cfg.context_length, train_ratio=0.9,
                         seed=args.seed, **shard)
    if args.finetune:
        # the pad id is the config's eos, as in the JAX package
        loader = InstructLoader(comps.tokenizer, pad_token_id=cfg.eos_id,
                                dataset_name=args.dataset, **loader_kwargs)
    else:
        loader = PretrainLoader(comps.tokenizer, stride=cfg.context_length,
                                token_cache_dir=args.tokenizer_cache_dir,
                                **loader_kwargs)
    if collectives.is_coordinator():
        os.makedirs(args.output_dir, exist_ok=True)
    collectives.sync_global_devices("output_dir")
    # a fleet checkpoint in the same output dir shares the model_pg_ prefix
    # but is not a trainer state: auto-discovery skips it
    resume_from = resolve_resume_agreed(
        args.resume, args.resume_from, args.output_dir,
        predicate=lambda meta: not meta.get("fleet"))
    watchdog = (LossWatchdog(spike_factor=args.loss_spike_factor,
                             window=args.watchdog_window)
                if args.watchdog == "on" and not (
                    comps.policy is not None and comps.policy.name == "fp16")
                else None)
    stopper = GracefulStopper()
    stall = StallDetector(args.stall_timeout) if args.stall_timeout > 0 else None
    trainer = Trainer(cfg, comps.model, comps.tokenizer, loader,
                      output_dir=args.output_dir, peak_lr=args.lr,
                      initial_lr=args.initial_lr, min_lr=args.min_lr,
                      warmup_steps=args.warmup_steps,
                      eval_freq=args.eval_freq,
                      print_sample_iter=args.print_sample_iter,
                      seed=args.seed, lora_params=comps.lora_params,
                      lora_alpha=args.lora_alpha if args.use_lora else None,
                      lora_rank=args.lora_rank if args.use_lora else None,
                      save_ckpt_freq=args.save_ckpt_freq,
                      resume_from=resume_from, keep_ckpts=args.keep_ckpts,
                      watchdog=watchdog, stopper=stopper, policy=comps.policy,
                      grad_accum=args.grad_accum, prefetch=args.prefetch,
                      async_ckpt=args.async_ckpt == "on", plan=comps.plan,
                      log_every=args.log_every, stall=stall,
                      profile_dir=(os.path.join(args.output_dir, "profile")
                                   if args.profile else None),
                      profile_steps=args.profile_steps)
    # started here, not at construction, so the first step's timer does not
    # charge the setup
    try:
        if stall is not None:
            stall.start()
        with stopper:
            if args.finetune:
                trainer.finetune_model(files, n_epochs=args.n_epochs)
            else:
                trainer.train_model(files, n_epochs=args.n_epochs)
    finally:
        if stall is not None:
            stall.stop()
    if trainer.preempted:
        logger.warning("Run preempted at step %d; interrupted checkpoint "
                       "written. Relaunch the same command to resume "
                       "(--resume auto).", trainer.global_step)
        return trainer
    if trainer.train_losses and collectives.is_coordinator():
        plot_run_losses(trainer, args.n_epochs, args.output_dir)
    logger.info("Training complete. Final model saved.")
    log_device_memory(logger, prefix="Peak device memory — ", device=device)
    trainer.save_checkpoint("final")
    trainer.export_final("model_pg_final.npz")
    if args.save_adapter:
        trainer.export_adapter(args.save_adapter)
    emit_event("run_complete", step=trainer.global_step,
               tokens_seen=trainer.tokens_seen,
               final_train_loss=(trainer.train_losses[-1]
                                 if trainer.train_losses else None))
    return trainer


def plot_run_losses(trainer, n_epochs: int, output_dir: str) -> Optional[str]:
    """``losses.pdf`` of the run's evaluations; without matplotlib one
    warning naming it, and no plot (None)."""
    import numpy as np

    from building_llm_from_scratch_tpu_torch.utils.plotting import plot_losses

    epochs_seen = np.linspace(0, n_epochs, len(trainer.train_losses))
    try:
        return plot_losses(epochs_seen, trainer.track_tokens_seen,
                           trainer.train_losses, trainer.val_losses, output_dir)
    except ImportError as e:
        logger.warning("losses.pdf not drawn: matplotlib is not installed "
                       "(%s)", e)
        return None


def _configure_logging() -> None:
    """INFO on rank 0, warnings only on the other ranks."""
    from building_llm_from_scratch_tpu_torch.parallel import collectives

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    if not collectives.is_coordinator():
        logging.getLogger().setLevel(logging.WARNING)


def _spawned_rank(local_rank: int, argv: List[str], world: int,
                  init_method: str) -> None:
    """One process of a run that ``run_multi_chip`` started: join the
    group as ``local_rank`` on ``cuda:<local_rank>`` and train."""
    from building_llm_from_scratch_tpu_torch.parallel import mesh

    os.environ["LOCAL_RANK"] = str(local_rank)
    args = get_args(argv)
    mesh.initialize_distributed(init_method=init_method, rank=local_rank,
                                world_size=world, device=args.device)
    try:
        _configure_logging()
        run_train(args)
    finally:
        mesh.shutdown_distributed()


def run_multi_chip(args, argv: Optional[List[str]]):
    """``--run_type multi_chip``: train in the caller's group, in
    torchrun's, or in one started here (module docstring). Returns the
    Trainer of this process's rank, or None when it started one process
    per card (their trainers live in those processes)."""
    import tempfile

    import torch.distributed as dist

    from building_llm_from_scratch_tpu_torch.parallel import mesh

    if dist.is_initialized():
        _configure_logging()
        return run_train(args)
    n = 1
    if "WORLD_SIZE" not in os.environ and args.device == "cuda":
        n = torch.cuda.device_count()
    init_dir = tempfile.mkdtemp(prefix="bllm-dist-")
    init_method = f"file://{os.path.join(init_dir, 'rendezvous')}"
    try:
        if n > 1:
            import torch.multiprocessing as mp

            argv = list(argv) if argv is not None else sys.argv[1:]
            mp.spawn(_spawned_rank, args=(argv, n, init_method), nprocs=n)
            return None
        if "WORLD_SIZE" in os.environ:
            mesh.initialize_distributed(device=args.device)
        else:
            mesh.initialize_distributed(init_method=init_method, rank=0,
                                        world_size=1, device=args.device)
        try:
            _configure_logging()
            return run_train(args)
        finally:
            mesh.shutdown_distributed()
    finally:
        import shutil

        shutil.rmtree(init_dir, ignore_errors=True)


def run(argv: Optional[List[str]] = None):
    """Parse the flags and run: ``--mode train`` returns the Trainer (None
    from a launcher that started one process per card), ``--mode serve``
    the shut-down engine."""
    args = get_args(argv)
    if args.mode == "serve":
        from building_llm_from_scratch_tpu_torch.serving.frontend import (
            run_serve,
        )

        return run_serve(args)
    if args.run_type == "multi_chip":
        return run_multi_chip(args, argv)
    _configure_logging()
    return run_train(args)


if __name__ == "__main__":
    run()
