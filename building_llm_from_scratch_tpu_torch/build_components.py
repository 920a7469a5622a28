"""The component factory (port of the single-device half of the JAX
package's ``build_components.py``): flags -> config, model (seeded init,
an ``.npz`` export, or pretrained weights from ``--weights_dir``),
tokenizer, with ``--use_lora`` the adapter, and the precision policy
(``--mixed_precision``; ``--data_type fp16`` alone gets the fp16 policy, so
it trains with loss scaling).

The seeded init draws from a ``torch.Generator`` seeded with ``--seed``
(the adapter's A from one seeded with ``--seed + 1``, as the JAX package
keys it with ``PRNGKey(seed + 1)``), not from JAX's stream, so the same
seed gives other weights than the JAX package; ``--init_params_from``
loads the same weights into both.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional

import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig, get_config
from building_llm_from_scratch_tpu_torch.data.tokenizers import build_tokenizer
from building_llm_from_scratch_tpu_torch.models.lora import (
    count_lora_params,
    init_lora_params,
)
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    build_model,
)
from building_llm_from_scratch_tpu_torch.training.precision import (
    PrecisionPolicy,
    get_policy,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Components:
    cfg: ModelConfig
    model: Transformer
    tokenizer: Any
    #: the adapter tree of a --use_lora run
    lora_params: Optional[dict] = None
    #: the --mixed_precision policy (the fp16 one for --data_type fp16)
    policy: Optional[PrecisionPolicy] = None


def build_config(args) -> ModelConfig:
    """Flags -> ModelConfig. GPT-2's HF checkpoints carry q/k/v biases, so
    ``--load_weights --model GPT2`` builds the config with them."""
    return get_config(
        args.model, args.num_params, dtype=args.data_type,
        qkv_bias=True if (args.load_weights and args.model == "GPT2") else None,
        use_actv_ckpt=args.use_actv_ckpt,
        debug=args.debug,
        target_context_length=(args.target_context_length or None))


def build_params(args, cfg: ModelConfig, device: torch.device) -> Transformer:
    """The model with weights from ``--load_weights --weights_dir`` (the
    pretrained files, converted leaf by leaf onto ``device``),
    ``--init_params_from`` or a seeded init (``--seed``), made on
    ``device``."""
    if args.load_weights:
        from building_llm_from_scratch_tpu_torch.weights import load_hf_weights

        flat = load_hf_weights(args.model, args.num_params, cfg,
                               weights_dir=args.weights_dir, device=device)
        logger.info("Loaded pretrained weights from %s", args.weights_dir)
        return Transformer(cfg, flat)
    if args.init_params_from:
        from building_llm_from_scratch_tpu_torch.training.checkpoint import (
            load_exported_params,
        )

        model = load_exported_params(args.init_params_from, cfg, device)
        logger.info("Initialized params from %s", args.init_params_from)
        return model
    return build_model(cfg, args.seed, device)


def build_components(args, device: torch.device) -> Components:
    """Config, model, tokenizer, (``--use_lora``) adapter and precision
    policy of a training run."""
    cfg = build_config(args)
    policy = get_policy(args.mixed_precision)
    if policy is None and args.data_type == "fp16":
        # fp16 alone must not train without a scaler: its 5-bit exponent
        # underflows LM gradients, so the fp16 policy (loss scaling) comes
        # with it, as in the JAX package
        logger.info("--data_type fp16: enabling dynamic loss scaling "
                    "(fp16 mixed-precision policy)")
        policy = get_policy("fp16")
    model = build_params(args, cfg, device)
    logger.info("Total parameters: %s", f"{cfg.num_params():,}")
    lora_params = None
    if args.use_lora:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed + 1)
        lora_params = init_lora_params(cfg, gen, args.lora_rank, device)
        logger.info("Total trainable LoRA parameters: %s",
                    f"{count_lora_params(lora_params):,}")
    return Components(cfg=cfg, model=model,
                      tokenizer=build_tokenizer(args.model, args.byte_tokenizer),
                      lora_params=lora_params, policy=policy)
