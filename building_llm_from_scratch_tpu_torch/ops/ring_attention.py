"""Ring attention: causal GQA attention with T split over the ``seq`` axis
(port of the JAX package's ``ops/ring_attention.py``, sequence
parallelism).

Each rank holds a contiguous T / S block of q, k and v (global positions
``rank * Tl ...``). The k/v blocks travel one hop a step round the seq
group (``parallel.collectives.ring_shift``), so after S - 1 hops every
query block has met every key block. Scores are fp32 (the JAX
``preferred_element_type=float32``), the softmax is online (running max,
sum and numerator), and the output is cast back to v's dtype. A key block
wholly after the query block is skipped: under the JAX online update it
adds exact zeros. With tensor parallelism each model rank rings its own
heads.

The JAX ring is XLA, not a Pallas kernel, so there is no TPU kernel to
port here: each hop is plain torch (``torch.einsum``), on the card as on
the CPU. It is not a kernel's fallback.

Attention dropout draws one mask per global (query, key, head) element:
``ops/philox.attention_keep_mask`` at the block's global offsets, the mask
B1 draws on one rank over the whole sequence. As in JAX the kept terms
enter the numerator, not the denominator, and the output is scaled by
1 / (1 - rate).

``RingAttention`` saves q, k, v, the output and the log-sum-exp and no
hop's scores. Its backward runs the ring again, recomputing each hop's
scores from the saved lse; the dk / dv of a key block travel with it and
reach its owner after S hops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from building_llm_from_scratch_tpu_torch.ops.philox import attention_keep_mask
from building_llm_from_scratch_tpu_torch.parallel import collectives as coll
from building_llm_from_scratch_tpu_torch.parallel.mesh import SEQ_AXIS

_NEG_INF = -1e30


def _keep(seed: int, rate: float, q: torch.Tensor, Hkv: int, src: int,
          rank: int, h0: int) -> torch.Tensor:
    """The (B, Hkv, G, Tl, Tl) keep mask of query block ``rank`` against
    key block ``src``."""
    B, Tl, Hq, _ = q.shape
    keep = attention_keep_mask(seed, B, Hq, Tl, Tl, rate, q.device,
                               q0=rank * Tl, k0=src * Tl, h0=h0)
    return keep.reshape(B, Hkv, Hq // Hkv, Tl, Tl)


def _scores(qg: torch.Tensor, k: torch.Tensor, diag: bool, scale: float
            ) -> torch.Tensor:
    """fp32 scaled scores (B, Hkv, G, Tl, Tl); the diagonal block causal."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if diag:
        Tl = qg.shape[1]
        pos = torch.arange(Tl, device=qg.device)
        s = torch.where(pos[:, None] >= pos[None, :], s,
                        torch.full((), _NEG_INF, device=qg.device))
    return s


def ring_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       group=None, n: int, rank: int, rate: float = 0.0,
                       seed: int = 0, h0: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (out (B, Tl, Hq, D) in v's dtype, lse (B, Hkv, G, Tl)
    fp32) over the ``n`` ranks of ``group`` (the JAX
    ``_ring_attention_local``)."""
    B, Tl, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / float(D) ** 0.5
    qg = q.reshape(B, Tl, Hkv, G, D).float()
    m = torch.full((B, Hkv, G, Tl), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(B, Hkv, G, Tl, D, dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for r in range(n):
        src = (rank - r) % n
        if src <= rank:
            s = _scores(qg, kc, src == rank, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            if rate > 0.0:
                p = torch.where(_keep(seed, rate, q, Hkv, src, rank, h0), p, 0.0)
            o = o * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc.float())
            m = m_new
        if r + 1 < n:
            kc, vc = coll.ring_shift([kc, vc], group, SEQ_AXIS)
    out = o / torch.clamp_min(l, 1e-37)[..., None]
    if rate > 0.0:
        out = out * (1.0 / (1.0 - rate))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tl, Hq, D).to(v.dtype)
    return out, m + torch.log(l)


def ring_attention_bwd(q, k, v, out, lse, do, *, group=None, n: int, rank: int,
                       rate: float = 0.0, seed: int = 0, h0: int = 0):
    """(dq, dk, dv) of ``ring_attention_fwd``: the ring again, each hop's
    probabilities recomputed from ``lse``; a key block's dk / dv ride with
    it and are back at its owner after ``n`` hops."""
    B, Tl, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / float(D) ** 0.5
    qg = q.reshape(B, Tl, Hkv, G, D).float()
    dog = do.reshape(B, Tl, Hkv, G, D).float()
    delta = (dog * out.reshape(B, Tl, Hkv, G, D).float()).sum(dim=-1)
    delta = delta.permute(0, 2, 3, 1)                       # (B, Hkv, G, Tl)
    dq = torch.zeros_like(qg)
    kc, vc = k, v
    dk = torch.zeros(B, Tl, Hkv, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    for r in range(n):
        src = (rank - r) % n
        if src <= rank:
            p = torch.exp(_scores(qg, kc, src == rank, scale) - lse[..., None])
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vc.float())
            if rate > 0.0:
                keep = _keep(seed, rate, q, Hkv, src, rank, h0)
                pz = torch.where(keep, p * inv, 0.0)
                dp = torch.where(keep, dp * inv, 0.0)
            else:
                pz = p
            dv = dv + torch.einsum("bhgqk,bqhgd->bkhd", pz, dog)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kc.float())
            dk = dk + torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
        if r + 1 < n:
            kc, vc, dk, dv = coll.ring_shift([kc, vc, dk, dv], group, SEQ_AXIS)
        else:
            dk, dv = coll.ring_shift([dk, dv], group, SEQ_AXIS)
    return (dq.reshape(B, Tl, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class RingAttention(torch.autograd.Function):
    """The ring forward saving q, k, v, out and lse (no scores); the
    backward is ``ring_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, ring: dict):
        out, lse = ring_attention_fwd(q, k, v, **ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_attention_bwd(q, k, v, out, lse, do, **ctx.ring)
        return dq, dk, dv, None


def ring_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          group=None, n: int, rank: int, dropout_rate: float = 0.0,
                          seed: Optional[int] = None, h0: int = 0) -> torch.Tensor:
    """Causal attention of this rank's (B, Tl, Hq, D) query block over the
    ring's key/value blocks (the JAX ``ring_causal_attention`` inside its
    shard_map), differentiable."""
    if n < 2:
        raise ValueError("ring_causal_attention needs a seq axis > 1; use "
                         "ops.attention.causal_attention instead")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("attention dropout requires a seed")
    ring = dict(group=group, n=n, rank=rank, rate=float(dropout_rate),
                seed=int(seed or 0), h0=int(h0))
    return RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), ring)
