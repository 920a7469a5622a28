"""Mixed-precision policies (the port's copy of the JAX package's
``training/precision.py``).

Two precision mechanisms, as in the reference:
  1. the whole-model dtype (``--data_type fp32|fp16|bf16``): the config's
     dtype, applied to the parameters and the activations;
  2. the ``--mixed_precision`` policies fp16 / bf16 / bf16_hybrid / fp32
     with their parameter (compute), gradient-reduce and master dtypes.

Master parameters stay in the model's dtype; the train step casts a
compute copy of every leaf to ``compute_dtype`` for the forward and the
backward, and the gradients reach the masters through the cast in the
masters' dtype. ``reduce_dtype`` is the dtype of cross-device gradient
reductions, which a single-device step does not make: ``bf16_hybrid``
(fp32 compute, bf16 reductions) is an fp32 step on one device, as the
JAX single-device step is. The fp16 policy carries dynamic loss scaling
(``training/train_step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from building_llm_from_scratch_tpu_torch.configs import DTYPE_MAP


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    compute_dtype: str = "fp32"   # dtype the parameters are cast to
    reduce_dtype: str = "fp32"    # dtype gradients are reduced in
    master_dtype: str = "fp32"    # dtype of the optimizer's master params
    # dynamic loss scaling (fp16 only): fp16's 5-bit exponent underflows on
    # typical LM gradients, so the loss is scaled up before the backward
    # and the gradients unscaled after; a non-finite step is skipped and
    # halves the scale, a streak of finite steps doubles it
    init_loss_scale: float = 2.0 ** 15
    scale_growth_interval: int = 2000

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return DTYPE_MAP[self.compute_dtype]

    @property
    def loss_scaling(self) -> bool:
        return self.compute_dtype == "fp16"


# the reference's name -> policy table
POLICIES = {
    "fp16": PrecisionPolicy("fp16", compute_dtype="fp16", reduce_dtype="fp16"),
    "bf16": PrecisionPolicy("bf16", compute_dtype="bf16", reduce_dtype="bf16"),
    "bf16_hybrid": PrecisionPolicy("bf16_hybrid", compute_dtype="fp32",
                                   reduce_dtype="bf16"),
    "fp32": PrecisionPolicy("fp32"),
}


def get_policy(name: Optional[str]) -> Optional[PrecisionPolicy]:
    """Look up a mixed-precision policy (None -> no policy: the model's
    dtype throughout)."""
    if name is None:
        return None
    if name not in POLICIES:
        raise ValueError(f"Unknown mixed-precision policy '{name}'; "
                         f"options: {list(POLICIES)}")
    return POLICIES[name]


def cast_floating(tree: Dict[str, torch.Tensor], dtype: torch.dtype
                  ) -> Dict[str, torch.Tensor]:
    """Cast the floating-point tensors of a flat tree to ``dtype`` (others
    untouched). Differentiable: a cast's backward hands the gradient back
    in the source's dtype, and a leaf already in ``dtype`` is returned
    itself."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}
