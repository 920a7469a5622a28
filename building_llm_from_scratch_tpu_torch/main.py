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
warning and goes on without the plot. Not ported: the stall detector
(ROADMAP queue 1, serving operations).
"""

from __future__ import annotations

import logging
import os
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
    from building_llm_from_scratch_tpu_torch.training.resilience import (
        GracefulStopper,
        LossWatchdog,
        resolve_resume,
    )
    from building_llm_from_scratch_tpu_torch.training.trainer import Trainer
    from building_llm_from_scratch_tpu_torch.utils.io import (
        discover_training_files,
    )
    from building_llm_from_scratch_tpu_torch.utils.seeding import set_seed

    device = resolve_device(args.device)
    set_seed(args.seed, device)
    comps = build_components(args, device)
    cfg = comps.cfg

    txt_files, json_files = discover_training_files(args.data_dir)
    files = json_files if args.finetune else txt_files
    if not files:
        raise FileNotFoundError("No training files found in specified directory.")
    logger.info("Total training files detected: %d", len(files))
    loader_kwargs = dict(batch_size=args.batch_size,
                         max_length=cfg.context_length, train_ratio=0.9,
                         seed=args.seed)
    if args.finetune:
        # the pad id is the config's eos, as in the JAX package
        loader = InstructLoader(comps.tokenizer, pad_token_id=cfg.eos_id,
                                dataset_name=args.dataset, **loader_kwargs)
    else:
        loader = PretrainLoader(comps.tokenizer, stride=cfg.context_length,
                                **loader_kwargs)
    os.makedirs(args.output_dir, exist_ok=True)
    # a fleet checkpoint in the same output dir shares the model_pg_ prefix
    # but is not a trainer state: auto-discovery skips it
    resume_from = resolve_resume(args.resume, args.resume_from,
                                 args.output_dir,
                                 predicate=lambda meta: not meta.get("fleet"))
    watchdog = (LossWatchdog(spike_factor=args.loss_spike_factor,
                             window=args.watchdog_window)
                if args.watchdog == "on" and not (
                    comps.policy is not None and comps.policy.name == "fp16")
                else None)
    stopper = GracefulStopper()
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
                      async_ckpt=args.async_ckpt == "on")
    with stopper:
        if args.finetune:
            trainer.finetune_model(files, n_epochs=args.n_epochs)
        else:
            trainer.train_model(files, n_epochs=args.n_epochs)
    if trainer.preempted:
        logger.warning("Run preempted at step %d; interrupted checkpoint "
                       "written. Relaunch the same command to resume "
                       "(--resume auto).", trainer.global_step)
        return trainer
    if trainer.train_losses:
        plot_run_losses(trainer, args.n_epochs, args.output_dir)
    logger.info("Training complete. Final model saved.")
    if device.type == "cuda":
        logger.info("Peak device memory — %.2f GB allocated",
                    torch.cuda.max_memory_allocated(device) / 1e9)
    trainer.save_checkpoint("final")
    trainer.export_final("model_pg_final.npz")
    if args.save_adapter:
        trainer.export_adapter(args.save_adapter)
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


def run(argv: Optional[List[str]] = None):
    """Parse the flags and run: ``--mode train`` returns the Trainer,
    ``--mode serve`` the shut-down engine."""
    args = get_args(argv)
    if args.mode == "serve":
        from building_llm_from_scratch_tpu_torch.serving.frontend import (
            run_serve,
        )

        return run_serve(args)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    return run_train(args)


if __name__ == "__main__":
    run()
