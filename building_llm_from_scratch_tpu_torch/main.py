"""Entry point: ``python -m building_llm_from_scratch_tpu_torch --mode train``
(pretraining) or ``--mode serve``.

Training follows the JAX ``main``: seed, components (config, model,
tokenizer), training files, loader, trainer (with a warm-up sample before
the first step), training, peak device memory, final ``.npz`` export. Not
ported: the loss plot, the watchdog, the stall detector, resume and the
train-state checkpoint.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import torch

from building_llm_from_scratch_tpu_torch.args import get_args

logger = logging.getLogger("building_llm_from_scratch_tpu_torch.main")


def run_train(args):
    """Pretrain from the parsed flags; returns the Trainer (its loss
    history, samples and model)."""
    from building_llm_from_scratch_tpu_torch.build_components import (
        build_components,
    )
    from building_llm_from_scratch_tpu_torch.data.pretrain import PretrainLoader
    from building_llm_from_scratch_tpu_torch.device import resolve_device
    from building_llm_from_scratch_tpu_torch.training.trainer import Trainer
    from building_llm_from_scratch_tpu_torch.utils.io import (
        discover_training_files,
    )
    from building_llm_from_scratch_tpu_torch.utils.seeding import set_seed

    device = resolve_device(args.device)
    set_seed(args.seed, device)
    comps = build_components(args, device)
    cfg = comps.cfg

    files, _ = discover_training_files(args.data_dir)
    if not files:
        raise FileNotFoundError("No training files found in specified directory.")
    logger.info("Total training files detected: %d", len(files))
    loader = PretrainLoader(comps.tokenizer, batch_size=args.batch_size,
                            max_length=cfg.context_length,
                            stride=cfg.context_length, train_ratio=0.9,
                            seed=args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    trainer = Trainer(cfg, comps.model, comps.tokenizer, loader,
                      output_dir=args.output_dir, peak_lr=args.lr,
                      initial_lr=args.initial_lr, min_lr=args.min_lr,
                      warmup_steps=args.warmup_steps,
                      eval_freq=args.eval_freq,
                      print_sample_iter=args.print_sample_iter,
                      seed=args.seed)
    trainer.train_model(files, n_epochs=args.n_epochs)
    logger.info("Training complete. Final model saved.")
    if device.type == "cuda":
        logger.info("Peak device memory — %.2f GB allocated",
                    torch.cuda.max_memory_allocated(device) / 1e9)
    trainer.export_final("model_pg_final.npz")
    return trainer


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
