"""Optimizer and LR schedule (port of the JAX package's ``training/optim.py``).

The JAX optimizer is the optax chain
``clip_by_global_norm(1.0) -> scale_by_adam(b1, b2, eps) ->
add_decayed_weights(0.1) -> scale_by_learning_rate(schedule)``. ``AdamW``
below computes the same update with optax's formulas, written by hand (the
usual torch helpers differ: ``clip_grad_norm_`` divides by ``norm + 1e-6``
and ``torch.optim.AdamW`` decays before the Adam step):

  clip    g <- g if norm < max_norm else (g / norm) * max_norm, no epsilon
          (norm: the global L2 norm over every leaf; see Dtypes)
  Adam    mu <- b1 mu + (1 - b1) g;  nu <- b2 nu + (1 - b2) g^2;
          u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps), n = steps
          so far including this one (eps outside the sqrt, eps_root = 0)
  decay   u <- u + weight_decay * p on EVERY leaf (no mask)
  lr      u <- -lr(count) * u, count = updates before this one; the
          schedule sees the pre-incremented step count + 1

Dtypes: every leaf's arithmetic runs in its own dtype, as optax's does with
no ``mu_dtype`` and no precision policy: the moments are kept in the
parameter dtype, each operation's result is rounded to that dtype, and the
constants (b1, 1 - b1, b2, 1 - b2, eps, the weight decay, the clip limit,
the bias corrections and the step size) are rounded to it first, as JAX
rounds a weak-typed Python scalar. For bf16 that makes b1 0.8984375 and b2
exactly 1.0, so the second moment does not decay: optax's own bf16
behaviour, kept on purpose. The global norms (clip and metrics) sum each
leaf's squares in fp32, round the sum to the leaf's dtype, and add the
leaves and take the root in that dtype (``optax.global_norm``). Each step
updates parameters, moments and the gradient buffers in place.

Gradients wider than their 16-bit parameters (fp32, from an accumulating
or a loss-scaled step) promote as JAX promotes them: the moments become
fp32 at the first such update (optax keeps the promoted moments, having
no ``mu_dtype``), the Adam arithmetic and the step size run in fp32, the
weight-decay term stays in the parameter's dtype, and the parameter gets
the fp32 sum rounded to its dtype (``optax.apply_updates``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np
import torch

Flat = Dict[str, torch.Tensor]


def warmup_cosine_schedule(peak_lr: float, initial_lr: float, min_lr: float,
                           warmup_steps: int, total_steps: int
                           ) -> Callable[[int], float]:
    """The reference's LR curve: linear warmup from ``initial_lr``, then
    cosine decay to ``min_lr`` over ``total_steps``. ``schedule(count)``
    takes the number of updates made so far; the first update sees
    global_step = 1 (the reference's pre-incremented counter)."""
    warmup_steps = max(1, warmup_steps)
    lr_increment = (peak_lr - initial_lr) / warmup_steps
    f32 = np.float32

    def schedule(count: int) -> float:
        # in float32, operation for operation as the JAX schedule computes
        step = int(count) + 1
        if step < warmup_steps:
            return float(f32(initial_lr) + f32(step) * f32(lr_increment))
        progress = f32(step - warmup_steps) / f32(max(1, total_steps - warmup_steps))
        cosine = np.cos(f32(math.pi) * progress, dtype=f32)
        return float(f32(min_lr) + f32((peak_lr - min_lr) * 0.5) * (f32(1.0) + cosine))

    return schedule


@dataclass
class AdamState:
    count: int = 0
    mu: Flat = field(default_factory=dict)
    nu: Flat = field(default_factory=dict)


@functools.lru_cache(maxsize=256)
def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (through fp32), as JAX rounds a Python
    scalar that meets an array of that dtype."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def global_norm(tree: Flat) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum over leaves of each leaf's
    sum of squares (accumulated in fp32, rounded to the leaf's dtype); a
    0-d tensor in the leaves' dtype."""
    total = None
    for t in tree.values():
        sq = torch.linalg.vector_norm(t, dtype=torch.float32).square().to(t.dtype)
        total = sq if total is None else total + sq
    return total.sqrt()


class AdamW:
    """clip -> Adam -> decoupled weight decay -> -lr, with optax's formulas
    (module docstring). ``init`` makes the state, ``step`` applies one
    update in place."""

    def __init__(self, schedule: Callable[[int], float],
                 weight_decay: float = 0.1, grad_clip_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Flat) -> AdamState:
        return AdamState(count=0,
                         mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def step(self, params: Flat, grads: Flat, state: AdamState,
             grad_norm: torch.Tensor | None = None) -> dict:
        """Update ``params`` (and ``state``) in place from ``grads`` (which
        are clipped in place; ``grad_norm`` their global norm when the
        caller has it). Returns the pre-clip global ``grad_norm``, the
        global ``update_norm`` of the applied updates (0-d device tensors
        in the gradients' dtype, not synchronised) and the ``lr`` used (a
        float)."""
        b1, b2 = self.b1, self.b2
        if grad_norm is None:
            grad_norm = global_norm(grads)
        # clip without a host sync: divide by the norm and multiply by the
        # limit only when the norm reaches it (dividing/multiplying by 1 is
        # exact otherwise)
        keep = grad_norm < self.grad_clip_norm
        one = torch.ones_like(grad_norm)
        div = torch.where(keep, one, grad_norm)
        mult = torch.where(keep, one, torch.full_like(one, self.grad_clip_norm))
        lr = self.schedule(state.count)
        state.count += 1
        # the bias corrections in fp32, as optax computes 1 - decay**count
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(b1) ** f32(state.count))
        bc2 = float(f32(1.0) - f32(b2) ** f32(state.count))
        updates = {}
        for name, p in params.items():
            g = grads[name]
            mu, nu = state.mu[name], state.nu[name]
            # the moments' dtype: theirs, or the gradient's when that is
            # wider (module docstring)
            dt = torch.promote_types(mu.dtype, g.dtype)
            r = lambda x, dt=dt: _rounded(x, dt)  # noqa: E731
            rg = _rounded(1.0 - b1, g.dtype), _rounded(1.0 - b2, g.dtype)
            g.div_(div).mul_(mult)
            if mu.dtype != dt:
                mu = state.mu[name] = mu.to(dt)
                nu = state.nu[name] = nu.to(dt)
            # (1 - b) * g^k + b * m, each product rounded, then the sum
            mu.mul_(r(b1)).add_(g * rg[0])
            nu.mul_(r(b2)).add_(g.square().mul_(rg[1]))
            u = (mu / r(bc1)) / ((nu / r(bc2)).sqrt_().add_(r(self.eps)))
            u.add_(p * _rounded(self.weight_decay, p.dtype))
            u.mul_(r(-lr))
            p.add_(u)
            updates[name] = u
        return dict(grad_norm=grad_norm, update_norm=global_norm(updates), lr=lr)
