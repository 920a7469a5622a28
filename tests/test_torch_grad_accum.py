"""The port's gradient accumulation (``make_train_step(grad_accum=)``), the
``sums`` losses and activation checkpointing against the JAX package and
against the port's own full-batch step.

Same JAX-initialised weights and numpy batches on both sides, dropout 0
(the two packages draw different masks). Parameters are compared by each
leaf's total update (the relative L2 of the difference to the reference
leaf's update: Adam divides each gradient by its own scale, so a
coordinate with a gradient near the summation noise moves by about the
learning rate either way). Tolerances: fp32 losses 1e-6 relative and
updates 1e-3; bf16 masters the bounds of ``tests/test_torch_precision.py``'s
bf16 policy (loss 1e-4, updates 0.25). The sums agree to 1e-6 relative.
Remat is checked bit for bit: the recompute repeats the same operations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.ops.softmax_xent import (
    fused_cross_entropy_sums as jfused_sums,
)
from building_llm_from_scratch_tpu.training import precision as jprec
from building_llm_from_scratch_tpu.training.optim import (
    build_optimizer,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu.training.train_step import (
    cross_entropy_sums as jdense_sums,
    init_train_state as jinit_state,
    make_train_step as jmake_train_step,
)
from building_llm_from_scratch_tpu_torch.models import transformer as ttf
from building_llm_from_scratch_tpu_torch.ops.softmax_xent import (
    fused_cross_entropy_sums,
)
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import precision as tprec
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    flatten_tree,
    params_from_jax,
)
from torch_port_helpers import bits, jax_params, small_configs, to_np32

SCHED = (1e-3, 1e-5, 1e-6, 2, 10)


def _batches(jcfg, n, masked, rows=4, seed=0):
    """n batches with loss weights; ``masked`` zeroes a different prompt
    length in every row (an SFT-style mask whose supervised counts differ
    between microbatches)."""
    rng = np.random.default_rng(seed)
    T = jcfg.context_length
    out = []
    for _ in range(n):
        x = rng.integers(0, jcfg.vocab_size, (rows, T + 1))
        w = np.ones((rows, T), np.float32)
        if masked:
            for r in range(rows):
                w[r, : int(rng.integers(T // 4, 3 * T // 4))] = 0.0
        out.append((x[:, :-1], x[:, 1:], w))
    return out


def _port_run(tcfg, np_params, batches, grad_accum=1, policy=None):
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(*SCHED))
    state = tts.init_train_state(model, opt, policy=policy)
    step = tts.make_train_step(tcfg, opt, policy=policy, grad_accum=grad_accum)
    losses = []
    for x, y, w in batches:
        state, m = step(state, {"inputs": torch.from_numpy(x),
                                "targets": torch.from_numpy(y),
                                "weights": torch.from_numpy(w)})
        losses.append(m["loss"].item())
    return losses, state


def _jax_run(jcfg, params, batches, grad_accum=1, policy=None):
    sched = warmup_cosine_schedule(*SCHED)
    opt = build_optimizer(schedule=sched)
    state = jinit_state(params, opt, jax.random.PRNGKey(0), policy=policy)
    step = jmake_train_step(jcfg, opt, lr_schedule=sched, policy=policy,
                            grad_accum=grad_accum)
    losses = []
    for x, y, w in batches:
        state, m = step(state, {"inputs": jnp.asarray(x, jnp.int32),
                                "targets": jnp.asarray(y, jnp.int32),
                                "weights": jnp.asarray(w)})
        losses.append(float(m["loss"]))
    return losses, state


def _flat32(tree):
    return {k: to_np32(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


def _update_errors(got, want, init):
    """Each leaf's relative L2 error of its total update against ``want``'s
    (the module docstring)."""
    err = {}
    for k, v in got.items():
        moved = np.linalg.norm(want[k] - init[k])
        diff = np.linalg.norm(to_np32(v) - want[k])
        err[k] = diff / moved if moved else float(diff > 0)
    return err


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_accumulation_matches_jax_and_the_full_batch(kind, masked):
    """Two steps of 2 microbatches against the JAX ``train_step_accum``
    and against the port's full-batch step: the losses and every
    parameter, fp32."""
    jcfg, tcfg = small_configs(kind, context_length=32)
    params, np_params = jax_params(jcfg, seed=1)
    init = {k: to_np32(v) for k, v in flatten_tree(np_params).items()}
    batches = _batches(jcfg, 2, masked)
    loss_t, state_t = _port_run(tcfg, np_params, batches, grad_accum=2)
    loss_j, state_j = _jax_run(jcfg, params, batches, grad_accum=2)
    loss_f, state_f = _port_run(tcfg, np_params, batches)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-6)
    np.testing.assert_allclose(loss_t, loss_f, rtol=1e-6)
    full = {k: to_np32(v) for k, v in state_f.params.items()}
    for want in (_flat32(state_j["trainable"]), full):
        err = _update_errors(state_t.params, want, init)
        assert max(err.values()) <= 1e-3, err


def test_bf16_masters_accumulate_in_fp32_as_jax_does():
    """bf16 masters, 2 microbatches: the gradients sum in fp32, so the
    optimizer's moments become fp32 on both sides (optax keeps the
    promoted moments); losses and updates at the bf16 bounds."""
    jcfg, tcfg = small_configs("llama", dtype="bf16", context_length=32)
    params, np_params = jax_params(jcfg, seed=1)
    init = {k: to_np32(v) for k, v in flatten_tree(np_params).items()}
    batches = _batches(jcfg, 2, masked=True)
    loss_t, state_t = _port_run(tcfg, np_params, batches, grad_accum=2)
    loss_j, state_j = _jax_run(jcfg, params, batches, grad_accum=2)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    mu_j = jax.tree_util.tree_leaves(state_j["opt_state"][1].mu)
    assert {str(m.dtype) for m in mu_j} == {"float32"}
    for k, v in state_t.params.items():
        assert v.dtype == torch.bfloat16
        assert state_t.opt_state.mu[k].dtype == torch.float32, k
    err = _update_errors(state_t.params, _flat32(state_j["trainable"]), init)
    assert max(err.values()) <= 0.25, err


@pytest.mark.parametrize("route", ["fused", "dense"])
def test_sums_match_jax(route):
    """(sum nll x w, sum w) of both routes against the JAX functions on the
    same hidden states, head and masked weights."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w_head = (0.1 * rng.standard_normal((32, 100))).astype(np.float32)
    t = rng.integers(0, 100, (2, 16))
    wts = (rng.random((2, 16)) > 0.4).astype(np.float32)
    if route == "fused":
        got = fused_cross_entropy_sums(torch.from_numpy(h), torch.from_numpy(w_head),
                                       torch.from_numpy(t), torch.from_numpy(wts))
        want = jfused_sums(jnp.asarray(h), jnp.asarray(w_head),
                           jnp.asarray(t, jnp.int32), jnp.asarray(wts))
    else:
        logits = h @ w_head
        got = tts.cross_entropy_sums(torch.from_numpy(logits), torch.from_numpy(t),
                                     torch.from_numpy(wts))
        want = jdense_sums(jnp.asarray(logits), jnp.asarray(t, jnp.int32),
                           jnp.asarray(wts))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)
    assert got[1].item() == wts.sum()


def test_accumulation_with_fp16_scaling_still_skips_overflow():
    """fp16 policy + 2 microbatches: an overflowing head skips the update,
    halves the scale and leaves the parameters bit-equal (JAX
    tests/test_training.py)."""
    jcfg, tcfg = small_configs("gpt2", context_length=32)
    _, np_params = jax_params(jcfg, seed=1)
    policy = tprec.get_policy("fp16")
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(*SCHED))
    state = tts.init_train_state(model, opt, policy=policy)
    with torch.no_grad():
        state.params["head/weight"].add_(1e5)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    x, y, w = _batches(jcfg, 1, masked=False)[0]
    step = tts.make_train_step(tcfg, opt, policy=policy, grad_accum=2)
    state, m = step(state, {"inputs": torch.from_numpy(x),
                            "targets": torch.from_numpy(y)})
    assert m["skipped"] == 1 and m["loss_scale"] == 2.0 ** 14
    for k, v in state.params.items():
        np.testing.assert_array_equal(bits(v), bits(before[k]), err_msg=k)


def test_accumulation_refuses_an_indivisible_batch():
    jcfg, tcfg = small_configs("gpt2", context_length=32)
    _, np_params = jax_params(jcfg, seed=1)
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(*SCHED))
    state = tts.init_train_state(model, opt)
    step = tts.make_train_step(tcfg, opt, grad_accum=3)
    x, y, _ = _batches(jcfg, 1, masked=False)[0]
    with pytest.raises(ValueError, match="divisible"):
        step(state, {"inputs": torch.from_numpy(x), "targets": torch.from_numpy(y)})
    with pytest.raises(ValueError, match="grad_accum"):
        tts.make_train_step(tcfg, opt, grad_accum=0)


@pytest.fixture
def deterministic_torch():
    """Deterministic CPU kernels: the embedding backward's index_put sums
    in thread order otherwise."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("policy", [None, "bf16"])
def test_remat_gradients_equal_the_saved_ones(deterministic_torch, policy):
    """GPT-2 with dropout 0.1 at T 256 (the flash and dropout twins, whose
    masks the recompute draws again from the same seeds): with
    ``use_actv_ckpt`` each block recomputes its forward in the backward,
    and the gradients and the loss are bit-equal to the run that saved the
    activations; the remat run saves fewer tensors."""
    jcfg, tcfg = small_configs("gpt2", context_length=256, emb_dim=128,
                               n_heads=2, n_kv_groups=2, drop_rate=0.1)
    _, np_params = jax_params(jcfg, seed=2)
    x = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 257))
    batch = {"inputs": torch.from_numpy(x[:, :-1]), "targets": torch.from_numpy(x[:, 1:])}
    out = []
    for remat in (False, True):
        cfg = tcfg.replace(use_actv_ckpt=remat)
        model = params_from_jax(np_params, cfg, "cpu")
        opt = topt.AdamW(lambda count: 0.0)
        p = tprec.get_policy(policy)
        state = tts.init_train_state(model, opt, seed=5, policy=p)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            _, m = tts.make_train_step(cfg, opt, policy=p)(state, batch)
        out.append((m["loss"], {k: g.clone() for k, g in state.grads.items()},
                    sum(saved)))
    (loss0, g0, n0), (loss1, g1, n1) = out
    assert bits(loss0) == bits(loss1)
    for k in g0:
        np.testing.assert_array_equal(bits(g1[k]), bits(g0[k]), err_msg=k)
        assert torch.count_nonzero(g0[k]) > 0, k
    assert n1 < n0
