"""The component factory (port of the single-device half of the JAX
package's ``build_components.py``): flags -> config, model (seeded init or
an ``.npz`` export) and tokenizer.

The seeded init draws from a ``torch.Generator`` seeded with ``--seed``,
not from JAX's stream, so the same seed gives other weights than the JAX
package; ``--init_params_from`` loads the same weights into both.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig, get_config
from building_llm_from_scratch_tpu_torch.data.tokenizers import build_tokenizer
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    build_model,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Components:
    cfg: ModelConfig
    model: Transformer
    tokenizer: Any


def build_config(args) -> ModelConfig:
    """Flags -> ModelConfig."""
    return get_config(args.model, args.num_params, dtype=args.data_type,
                      debug=args.debug,
                      target_context_length=(args.target_context_length or None))


def build_params(args, cfg: ModelConfig, device: torch.device) -> Transformer:
    """The model with weights from ``--init_params_from`` or a seeded init
    (``--seed``), made on ``device``."""
    if args.init_params_from:
        from building_llm_from_scratch_tpu_torch.training.checkpoint import (
            load_exported_params,
        )

        model = load_exported_params(args.init_params_from, cfg, device)
        logger.info("Initialized params from %s", args.init_params_from)
        return model
    return build_model(cfg, args.seed, device)


def build_components(args, device: torch.device) -> Components:
    """Config, model and tokenizer of a training run."""
    cfg = build_config(args)
    model = build_params(args, cfg, device)
    logger.info("Total parameters: %s", f"{cfg.num_params():,}")
    return Components(cfg=cfg, model=model,
                      tokenizer=build_tokenizer(args.model, args.byte_tokenizer))
