"""Chunked softmax cross entropy from the final hidden states (port of the
JAX package's ``ops/softmax_xent.py``, the custom-VJP loss its train step
takes for ``emb_dim <= 1024``).

The forward runs an online logsumexp over ``chunk``-wide slices of the head
product (fp32 logits of one chunk at a time; ``ops/xent_fwd.xent_fwd_plain``)
and saves only the per-token lse; the backward recomputes each
chunk's logits, rounds ``dl = (softmax - onehot) * g`` to the hidden
states' dtype and feeds it to the dx and dW products (fp32 accumulation, dW
written per chunk in the weight's dtype). The default chunk, 51200, makes
GPT-2's vocabulary one chunk.

The forward takes the vocab-streamed kernel B4 (``ops/xent_fwd.py``) under
the JAX package's own switch, ``BLLM_XENT_PALLAS=1``, on one CUDA device
and for shapes its ``supports_shape`` allows (``_use_kernel_fwd``, the JAX
``_use_pallas_fwd``): a route chosen before any launch. The products of
the chunked path and of the backward are plain large GEMMs outside any
kernel of the JAX package and go to ``torch.mm``.

``fused_cross_entropy_loss`` takes the JAX per-token loss weights
(instruction finetuning's prompt mask): sum(nll * w) / max(sum(w), 1), the
plain token mean without weights. The weights apply to the per-token nll
that ``SoftmaxXent`` (and B4) return, so neither changes.

``fused_cross_entropy_sums`` returns the loss's two pieces instead,
(sum(nll * w), sum(w)) in fp32 (w = 1 without weights), for the
accumulating step, which divides once over all its microbatches.

Not ported: ``BLLM_XENT_CHUNK`` / ``BLLM_XENT_FWD_CHUNK`` (the chunk is an
argument).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from building_llm_from_scratch_tpu_torch.ops.xent_fwd import (
    matmul_fp32,
    supports_shape,
    xent_fwd,
    xent_fwd_plain,
)

DEFAULT_CHUNK = 51200


def _use_kernel_fwd(x2: torch.Tensor, V: int) -> bool:
    """B4 is opt-in (``BLLM_XENT_PALLAS=1``), single-device, and gated by
    its ``supports_shape``; otherwise the chunked forward below."""
    if os.environ.get("BLLM_XENT_PALLAS", "0") != "1":
        return False
    if x2.device.type != "cuda" or torch.cuda.device_count() != 1:
        return False
    N, D = x2.shape
    return supports_shape(N, D, V)


def xent_fwd_impl(x2: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's route: B4 when ``_use_kernel_fwd``, else the chunked
    online logsumexp (B4's twin at this chunk)."""
    if _use_kernel_fwd(x2, w.shape[1]):
        return xent_fwd(x2, w, targets)
    return xent_fwd_plain(x2, w, targets, chunk)


class SoftmaxXent(torch.autograd.Function):
    """Per-token nll (N,) fp32 of hidden states x2 (N, D) under the head
    w (D, V); the backward of the JAX ``_xent_bwd``."""

    @staticmethod
    def forward(ctx, x2, w, targets, chunk):
        nll, lse = xent_fwd_impl(x2, w, targets, chunk)
        ctx.save_for_backward(x2, w, targets, lse)
        ctx.chunk = chunk
        return nll

    @staticmethod
    def backward(ctx, g):
        x2, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        V = w.shape[1]
        gx = g.float()[:, None]
        tgt = targets.long()
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dw = torch.empty_like(w)
        for c0 in range(0, V, chunk):
            wc = w[:, c0:c0 + chunk]
            width = wc.shape[1]
            # dl = (softmax - onehot) * g, in place on the chunk's logits
            p = matmul_fp32(x2, wc).sub_(lse[:, None]).exp_()
            local = tgt - c0
            hit = ((local >= 0) & (local < width)).float()
            p.scatter_add_(1, local.clamp(0, width - 1)[:, None], -hit[:, None])
            dl = p.mul_(gx).to(x2.dtype)
            dx += matmul_fp32(dl, wc.t())
            dw[:, c0:c0 + width] = matmul_fp32(x2.t(), dl).to(w.dtype)
        return dx.to(x2.dtype), dw, None, None


def softmax_xent(x2: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                 chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Per-token negative log-likelihood (N,) fp32, differentiable in x2
    and w; (N, V) fp32 logits never exist beyond one chunk."""
    return SoftmaxXent.apply(x2, w, targets, int(chunk))


def weighted_mean(nll: torch.Tensor, weights: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """The JAX loss's token mean: ``mean(nll)`` without weights, else
    sum(nll * w) / max(sum(w), 1) in fp32 (0 when every weight is 0)."""
    if weights is None:
        return nll.mean()
    w = weights.reshape(nll.shape).float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def weighted_sums(nll: torch.Tensor, weights: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum(nll * w), sum(w)) in fp32, w = 1 without weights: the
    unnormalised pieces of ``weighted_mean``."""
    w = (torch.ones_like(nll, dtype=torch.float32) if weights is None
         else weights.reshape(nll.shape).float())
    return (nll * w).sum(), w.sum()


def fused_cross_entropy_sums(hidden: torch.Tensor, w_head: torch.Tensor,
                             targets: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             chunk: int = DEFAULT_CHUNK
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted nll sum, weight sum) of (B, T, D) hidden states, fp32,
    through the same chunked route (B4 included) as
    ``fused_cross_entropy_loss``."""
    B, T, D = hidden.shape
    nll = softmax_xent(hidden.reshape(B * T, D), w_head,
                       targets.reshape(B * T), chunk)
    return weighted_sums(nll, weights)


def fused_cross_entropy_loss(hidden: torch.Tensor, w_head: torch.Tensor,
                             targets: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Weighted token-mean cross entropy of (B, T, D) hidden states, the
    same value as the dense ``cross_entropy_loss`` of their logits, without
    (B, T, V) fp32 logits."""
    B, T, D = hidden.shape
    nll = softmax_xent(hidden.reshape(B * T, D), w_head,
                       targets.reshape(B * T), chunk)
    return weighted_mean(nll, weights)
