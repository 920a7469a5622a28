"""Selective-save remat, the training forward's default (the JAX
``save_only_these_names`` policy of ``forward_hidden``): each block keeps
post-RoPE q, k, v, the attention's output and log-sum-exp, the mid-block
residual and the MLP's up / gate outputs, and its backward recomputes the
norms, the activations and the residual adds, never a GEMM or an attention
kernel.

Exactness: on the CPU (deterministic algorithms) the loss and every
gradient are bit-equal to the run that saves every activation
(the module's ``_SAVE_ALL``) and to full remat (``use_actv_ckpt``), with
dropout 0.1 through B1's and B3's twins at T 256 and under the bf16
policy. The census counts what autograd holds after the forward."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu_torch.configs import get_config
from building_llm_from_scratch_tpu_torch.models import transformer as tfm
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.precision import get_policy
from torch_port_helpers import bits

T = 256


def _cfg(kind: str):
    if kind == "gpt2":
        return dataclasses.replace(get_config("GPT2", "124M", debug=True), context_length=T,
                                   emb_dim=128, n_heads=2, n_kv_groups=2, n_layers=3,
                                   vocab_size=300, hidden_dim=512, drop_rate=0.1)
    return dataclasses.replace(get_config("llama3_2", "1B", debug=True), context_length=T,
                               emb_dim=256, n_heads=4, n_kv_groups=2, n_layers=3,
                               vocab_size=300, hidden_dim=512)


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _step(cfg, mode: str, policy, monkeypatch):
    """One step from the seeded model in remat ``mode``: (loss, grads)."""
    monkeypatch.setattr(tfm, "_SAVE_ALL", mode == "none")
    cfg = dataclasses.replace(cfg, use_actv_ckpt=mode == "full")
    assert tfm.remat_mode(cfg) == mode
    model = tfm.build_model(cfg, 0, "cpu")
    opt = topt.AdamW(lambda count: 0.0)
    p = get_policy(policy)
    state = tts.init_train_state(model, opt, seed=5, policy=p)
    x = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, T + 1)))
    _, m = tts.make_train_step(cfg, opt, policy=p)(
        state, {"inputs": x[:, :-1], "targets": x[:, 1:]})
    return m["loss"], {k: g.clone() for k, g in state.grads.items()}


@pytest.mark.parametrize("kind,policy", [("gpt2", None), ("llama", None),
                                         ("llama", "bf16")])
def test_selective_remat_is_bit_equal_to_save_all_and_full_remat(
        deterministic, monkeypatch, kind, policy):
    """The loss and every gradient of selective remat equal, bit for bit,
    those of the save-all run and of full remat (GPT-2: dropout 0.1, the
    masks regenerated from the same seeds; LLaMA fp32 and bf16)."""
    cfg = _cfg(kind)
    loss, grads = _step(cfg, "selective", policy, monkeypatch)
    for mode in ("none", "full"):
        other_loss, other = _step(cfg, mode, policy, monkeypatch)
        assert bits(other_loss) == bits(loss), mode
        for k, g in grads.items():
            np.testing.assert_array_equal(bits(other[k]), bits(g), err_msg=f"{mode} {k}")
            assert torch.count_nonzero(g) > 0, k


def _census(cfg, mode: str, monkeypatch) -> collections.Counter:
    """(shape, dtype) -> count of the activations autograd holds after a
    forward to the final norm (parameters left out)."""
    monkeypatch.setattr(tfm, "_SAVE_ALL", mode == "none")
    model = tfm.build_model(cfg, 0, "cpu")
    model.requires_grad_(True)
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    x = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, T)))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                  lambda t: t):
        tfm.forward_hidden(model, x)
    return collections.Counter((tuple(t.shape), t.dtype) for t in saved
                               if t.untyped_storage().data_ptr() not in params)


def test_census_each_block_saves_the_jax_names_only(monkeypatch):
    """LLaMA bf16, 3 blocks at T 256 (the flash twins): each block holds its
    input and exactly the JAX names' tensors: q (B, T, Hq, hd), k and v (B,
    T, Hkv, hd), the attention's output (B, T, Hq, hd) and lse (B, Hq, T),
    resid_mid (B, T, D), up_out and gate_out (B, T, F); no norm output and
    no activation output. Save-all holds more (every norm's and
    activation's output); outside the blocks only the embedding's ids and
    the final norm's fp32 tensors."""
    cfg = _cfg("llama")
    B, L, D, F = 2, cfg.n_layers, cfg.emb_dim, cfg.hidden_dim
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_groups, cfg.head_dim
    bf = torch.bfloat16
    got = _census(cfg, "selective", monkeypatch)
    per_block = collections.Counter({
        ((B, T, D), bf): 2,                        # the block input, resid_mid
        ((B, T, Hq, hd), bf): 2,                   # q, the attention output
        ((B, T, Hkv, hd), bf): 2,                  # k, v
        ((B, Hq, T), torch.float32): 1,            # lse
        ((B, T, F), bf): 2})                       # up_out, gate_out
    # outside the blocks: the embedding's token ids, the final norm's fp32
    # input and statistics
    final = collections.Counter({k: v for k, v in got.items()
                                 if k[1] == torch.int64 or (k[1] == torch.float32
                                                            and k[0] != (B, Hq, T))})
    assert final[((B, T), torch.int64)] == 1
    want = collections.Counter({k: v * L for k, v in per_block.items()}) + final
    assert got == want, (got, want)
    every = _census(cfg, "none", monkeypatch)
    assert sum(every.values()) > sum(got.values())
    assert every[((B, T, F), bf)] > got[((B, T, F), bf)]


def test_remat_mode_rule(monkeypatch):
    """Selective by default, full with use_actv_ckpt (also over the
    save-all switch), save-all with the module's ``_SAVE_ALL``; save-all
    under fsdp's per-layer gathers is refused, not replaced."""
    from building_llm_from_scratch_tpu_torch.parallel.tensor import SINGLE

    cfg = _cfg("llama")
    assert tfm._SAVE_ALL is False
    assert tfm.remat_mode(cfg) == "selective"
    assert tfm.remat_mode(dataclasses.replace(cfg, use_actv_ckpt=True)) == "full"
    monkeypatch.setattr(tfm, "_SAVE_ALL", True)
    assert tfm.remat_mode(cfg) == "none"
    assert tfm.remat_mode(dataclasses.replace(cfg, use_actv_ckpt=True)) == "full"
    model = tfm.build_model(cfg, 0, "cpu")
    par = dataclasses.replace(SINGLE, layers=object())
    with pytest.raises(ValueError, match="per-layer gathers"):
        tfm.forward_hidden(model, torch.zeros((1, T), dtype=torch.long), par=par)
