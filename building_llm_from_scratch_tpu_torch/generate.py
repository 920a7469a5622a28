"""Token sampling (port of the JAX package's ``generate.py``): the serving
engine's per-row temperature / top-k / seed sampling, the speculative
verify's per-position sampling and accept rule, the prompt-length buckets,
and the one-shot ``generate()`` the trainer samples with.

Randomness: JAX folds the token index into the request's key
(``token_rng(PRNGKey(seed), i)``); here token i of a request is drawn from a
``torch.Generator`` seeded with ``token_seed(seed, i)``. The two streams
differ, but each keeps the property the engine relies on: a request's tokens
depend only on its own (prompt, seed, params), never on its slot or on the
traffic beside it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def token_seed(seed: int, i: int) -> int:
    """The generator seed of token ``i`` of a request seeded ``seed``
    (splitmix64 of the pair, so nearby seeds and indices give unrelated
    streams)."""
    z = ((int(seed) & _MASK64) * 0x9E3779B97F4A7C15 + int(i) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def sample_tokens_dynamic(logits: torch.Tensor, seeds: np.ndarray,
                          token_index: np.ndarray, temperature: np.ndarray,
                          top_k: np.ndarray, max_top_k: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Per-row sampling of ``logits`` (S, V) fp32 with per-row parameters
    held on the host: ``seeds``/``token_index`` (S,) pick each row's
    generator seed, ``temperature`` (S,) (0 = greedy argmax) and ``top_k``
    (S,) (0 = off, else 1..max_top_k). Returns (S,) int64 token ids on the
    logits' device.

    The top-k rule is the JAX one: keep the values >= the k-th largest
    (ties at the threshold survive), set the rest to -inf. A sampled row
    draws ``argmax(logits / t + Gumbel noise)`` with the noise from its own
    generator, a categorical draw over softmax(logits / t)."""
    S, V = logits.shape
    dev = logits.device
    if (top_k > 0).any():
        K = min(max_top_k, V)
        vals = torch.topk(logits, K, dim=-1).values
        idx = torch.as_tensor(np.clip(top_k, 1, K) - 1, device=dev).long()
        kth = vals.gather(1, idx[:, None])
        on = torch.as_tensor(top_k > 0, device=dev)[:, None]
        logits = torch.where(on & (logits < kth),
                             torch.full((), -float("inf"), device=dev), logits)
    tokens = logits.argmax(dim=-1)
    rows = [s for s in range(S) if temperature[s] > 0.0]
    if rows:
        drawn = []
        for s in rows:
            generator.manual_seed(token_seed(seeds[s], token_index[s]))
            u = torch.rand(V, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u))
            drawn.append((logits[s] / float(temperature[s]) + gumbel).argmax())
        tokens[torch.as_tensor(rows, device=dev)] = torch.stack(drawn)
    return tokens


def sample_tokens_multi(logits: torch.Tensor, seeds: np.ndarray,
                        token_index: np.ndarray, temperature: np.ndarray,
                        top_k: np.ndarray, max_top_k: int,
                        generator: torch.Generator) -> torch.Tensor:
    """Per-position sampling of the speculative verify's ``logits`` (S, Tq,
    V): position j of row s is row s*Tq + j of one flattened
    ``sample_tokens_dynamic`` call, drawn with ``token_seed(seeds[s],
    token_index[s] + j)`` under row s's temperature and top-k: the token
    the one-token decode tick would draw for that token index from the same
    logits (every step of the sampler is row-wise). Returns (S, Tq) int64."""
    S, Tq, V = logits.shape
    rep = lambda a: np.repeat(np.asarray(a), Tq)  # noqa: E731  (s, j) -> s*Tq + j
    index = (np.asarray(token_index)[:, None] + np.arange(Tq)[None, :]).reshape(-1)
    flat = sample_tokens_dynamic(logits.reshape(S * Tq, V), rep(seeds), index,
                                 rep(temperature), rep(top_k), max_top_k,
                                 generator)
    return flat.reshape(S, Tq)


def accept_draft_tokens(logits: torch.Tensor, drafts: torch.Tensor,
                        seeds: np.ndarray, token_index: np.ndarray,
                        temperature: np.ndarray, top_k: np.ndarray,
                        max_top_k: int, generator: torch.Generator) -> tuple:
    """The speculative accept rule (the JAX ``accept_draft_tokens``):
    ``logits`` (S, k+1, V) from ``verify_slots``, ``drafts`` (S, k) the
    proposed tokens. Each position's own token t_j is drawn first
    (``sample_tokens_multi``, argmax at temperature 0); draft d_{j+1} is
    accepted iff it equals t_j, and the longest accepted run is committed
    as t_0 .. t_{n_acc}. For point-mass drafts this exact match is
    rejection sampling, and the committed tokens are the ones the spec-off
    engine would draw, since t_j rides the same per-token seed.

    A non-finite position stops the acceptance chain before it (committing
    t_j needs finite logits at j); ``ok`` is position 0's finiteness, which
    retires the row as the spec-off guard does. Returns (tokens (S, k+1),
    n_accepted (S,), ok (S,) bool), on the logits' device."""
    toks = sample_tokens_multi(logits, seeds, token_index, temperature, top_k,
                               max_top_k, generator)
    finite = torch.isfinite(logits).all(dim=-1)                 # (S, k+1)
    match = (toks[:, :-1] == drafts.to(toks.dtype)) & finite[:, 1:]
    n_acc = torch.cumprod(match.long(), dim=1).sum(dim=1)     # leading run
    return toks, n_acc, finite[:, 0]


def _bucket(n: int, step: int = 64, lo: int = 32) -> int:
    """Round up to the prompt-length bucket (multiples of ``step``, floor
    ``lo``), as the JAX package does for its compile shapes."""
    return max(lo, -(-n // step) * step)


def _sample_token(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int], generator: Optional[torch.Generator]
                  ) -> torch.Tensor:
    """Next-token ids from last-position logits (B, V): top-k filter first
    (values below the k-th largest -> -inf), then a draw from
    softmax(logits / temperature) (Gumbel-max with ``generator``), or the
    argmax when temperature is 0."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.full((), -float("inf"), device=logits.device),
                             logits)
    if temperature > 0.0:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        return (logits / temperature - torch.log(-torch.log(u))).argmax(dim=-1)
    return logits.argmax(dim=-1)


@torch.no_grad()
def generate(model, token_ids, max_new_tokens: int,
             context_size: Optional[int] = None, temperature: float = 0.0,
             top_k: Optional[int] = None, eos_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             ref_eos_semantics: bool = False,
             return_n_generated: bool = False, lora: Optional[dict] = None,
             lora_alpha: Optional[float] = None,
             lora_rank: Optional[int] = None):
    """Generate up to ``max_new_tokens`` after ``token_ids`` (B, Tp) and
    return a numpy (B, Tp + most generated) array of prompt + new ids.

    Each row stops at its own eos (the eos itself is dropped; rows that
    finish early are right-padded with ``eos_id``). ``ref_eos_semantics``
    keeps the reference's quirk instead: generation stops only when every
    row samples eos in the same step (that column is dropped); otherwise a
    row's eos is kept and stops nothing. ``return_n_generated`` also
    returns the tokens each row generated (B,). When the prompt plus
    the budget fits the context, the prompt (right-padded to its 64-token
    bucket) is prefilled into a KV cache and each new token is one cached
    forward (``forward_with_cache``: ``decode_attention`` over the cache);
    otherwise every token runs a full forward over the last
    ``context_size`` tokens (the reference's sliding window). Sampling with
    temperature > 0 draws from ``generator`` (torch's stream, not JAX's);
    greedy decoding (the default) is deterministic. ``lora`` (with
    ``lora_alpha`` and ``lora_rank``): decode with one adapter applied
    unmerged at every adapted projection and the head, the same math as
    its merge (``models.lora.apply_lora``)."""
    from building_llm_from_scratch_tpu_torch.models.transformer import (
        forward,
        forward_with_cache,
        init_slot_cache,
    )

    cfg = model.cfg
    dev = model.device
    context_size = context_size or cfg.context_length
    lora_kw = {}
    if lora is not None:
        if lora_alpha is None or lora_rank is None:
            raise ValueError("lora needs lora_alpha and lora_rank")
        lora_kw = dict(lora=lora, lora_scaling=float(lora_alpha) / float(lora_rank))
    ids = np.asarray(token_ids, dtype=np.int64)
    if ids.ndim == 1:
        ids = ids[None, :]
    B, Tp = ids.shape
    done = np.zeros((B,), bool)
    n_gen = np.zeros((B,), np.int32)
    pad = eos_id if eos_id is not None else 0

    def accept(nxt: np.ndarray) -> bool:
        """Record one sampled column; False once every row is done."""
        nonlocal ids, done, n_gen
        if ref_eos_semantics:
            if eos_id is not None and (nxt == eos_id).all():
                return False
            ids = np.concatenate([ids, nxt[:, None]], axis=1)
            n_gen += 1
            return True
        if eos_id is not None:
            done |= nxt == eos_id
        if done.all():
            return False
        col = np.where(~done, nxt, pad)
        ids = np.concatenate([ids, col[:, None]], axis=1)
        n_gen += (~done).astype(np.int32)
        return True

    if Tp + max_new_tokens <= context_size:
        Tpb = min(_bucket(Tp), context_size)
        budget = min(_bucket(max_new_tokens), context_size - Tpb)
        cache = init_slot_cache(cfg, B, Tpb + budget, dev)
        prompt = torch.zeros((B, Tpb), dtype=torch.long, device=dev)
        prompt[:, :Tp] = torch.as_tensor(ids, device=dev)
        last = forward_with_cache(model, prompt, cache, 0, **lora_kw)[:, Tp - 1]
        for i in range(max_new_tokens):
            nxt = _sample_token(last, float(temperature), top_k, generator)
            if not accept(nxt.cpu().numpy()) or i + 1 == max_new_tokens:
                break
            col = torch.as_tensor(ids[:, -1:], device=dev)
            last = forward_with_cache(model, col, cache, Tp + i, **lora_kw)[:, 0]
    else:
        for _ in range(max_new_tokens):
            cur = ids.shape[1]
            if cur >= context_size:
                window, last_pos = ids[:, -context_size:], context_size - 1
            else:
                window = np.concatenate(
                    [ids, np.zeros((B, context_size - cur), ids.dtype)], axis=1)
                last_pos = cur - 1
            logits = forward(model, torch.as_tensor(window, device=dev), **lora_kw)
            nxt = _sample_token(logits[:, last_pos], float(temperature), top_k,
                                generator)
            if not accept(nxt.cpu().numpy()):
                break
    return (ids, n_gen) if return_n_generated else ids


def text_to_token_ids(text: str, tokenizer) -> np.ndarray:
    """(1, T) int32 ids of ``text``."""
    ids = tokenizer.encode(text, allowed_special={"<|endoftext|>"})
    return np.asarray(ids, np.int32)[None, :]


def token_ids_to_text(token_ids, tokenizer) -> str:
    """Text of (T,) or (1, T) ids."""
    arr = np.asarray(token_ids)
    if arr.ndim == 2:
        arr = arr[0]
    return tokenizer.decode([int(t) for t in arr])
