"""The port's precision policies and fp16 loss scaling against the JAX
package (``training/precision.py``, ``make_train_step(policy=)``).

Both packages start from the same JAX-initialised weights (fp32 masters)
and take the same numpy batches. Tolerances, per policy (``STEP_TOL``):
the loss of every step, relative, and every leaf's total update after two
steps, as the relative L2 of the difference to the JAX leaf's update.
fp32 and bf16_hybrid (an fp32 step on one device) are the same arithmetic
in another order. bf16 and fp16 round every operation to 8 / 11 bits on
both sides, but at other places (the port's GEMMs accumulate in fp32 and
round once, XLA's CPU dot may not). Adam divides each gradient by its own
scale, so a coordinate whose gradient is below the rounding noise moves by
about the learning rate either way: the update bound is loose where the
loss bound is tight. Measured on the CPU: fp32 loss 8e-8, update 5e-5;
bf16 3e-5, 0.15 (the norm biases); fp16 2e-6, 0.04.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.training import checkpoint as jckpt
from building_llm_from_scratch_tpu.training import precision as jprec
from building_llm_from_scratch_tpu.training.optim import (
    build_optimizer,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu.training.train_step import (
    init_train_state as jinit_state,
    make_train_step as jmake_train_step,
)
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import precision as tprec
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    flatten_tree,
    params_from_jax,
    save_checkpoint,
)
from torch_port_helpers import bits, jax_params, small_configs, to_np32

#: (loss relative, update relative L2) of ``_steps_vs_jax``; see the
#: module docstring
STEP_TOL = {"fp32": (1e-6, 1e-3), "bf16_hybrid": (1e-6, 1e-3),
            "bf16": (1e-4, 0.25), "fp16": (1e-5, 0.1)}

SCHED = (5e-4, 1e-5, 1e-6, 2, 10)


def _batches(jcfg, n, seed=1, rows=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, jcfg.vocab_size, (rows, jcfg.context_length + 1))
            for _ in range(n)]


def _jax_feed(x):
    return {"inputs": jnp.asarray(x[:, :-1], jnp.int32),
            "targets": jnp.asarray(x[:, 1:], jnp.int32)}


def _port_feed(x):
    return {"inputs": torch.from_numpy(x[:, :-1]),
            "targets": torch.from_numpy(x[:, 1:])}


def _port(tcfg, np_params, policy, seed=0, **kw):
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(*SCHED))
    state = tts.init_train_state(model, opt, seed=seed, policy=policy)
    return model, state, tts.make_train_step(tcfg, opt, policy=policy, **kw)


def _jax(jcfg, params, policy, seed=0, **kw):
    sched = warmup_cosine_schedule(*SCHED)
    opt = build_optimizer(schedule=sched)
    state = jinit_state(params, opt, jax.random.PRNGKey(seed), policy=policy)
    return state, jmake_train_step(jcfg, opt, lr_schedule=sched, policy=policy,
                                   **kw)


def test_policy_table_equals_jax():
    assert list(tprec.POLICIES) == list(jprec.POLICIES)
    for name, policy in tprec.POLICIES.items():
        assert dataclasses.asdict(policy) == dataclasses.asdict(
            jprec.POLICIES[name]), name
        assert tprec.get_policy(name) is policy
    assert tprec.get_policy(None) is None
    with pytest.raises(ValueError, match="Unknown mixed-precision policy"):
        tprec.get_policy("fp8")


def _steps_vs_jax(name, kind="gpt2", n=2):
    """n steps of both packages under the policy ``name``: the (port, JAX)
    loss pairs and each leaf's update error (``STEP_TOL``)."""
    jcfg, tcfg = small_configs(kind, context_length=64)
    params, np_params = jax_params(jcfg, seed=3)
    init = {k: to_np32(v) for k, v in flatten_tree(np_params).items()}
    model, state_t, step_t = _port(tcfg, np_params, tprec.get_policy(name))
    state_j, step_j = _jax(jcfg, params, jprec.get_policy(name))
    losses = []
    for x in _batches(jcfg, n):
        state_j, mj = step_j(state_j, _jax_feed(x))
        state_t, mt = step_t(state_t, _port_feed(x))
        losses.append((mt["loss"].item(), float(mj["loss"])))
        np.testing.assert_allclose(mt["lr"], float(mj["lr"]), rtol=1e-6)
        if name == "fp16":
            assert mt["skipped"] == int(mj["skipped"]) == 0
            assert mt["loss_scale"] == float(mj["loss_scale"])
    final_j = {k: to_np32(v) for k, v in
               flatten_tree(jax.device_get(state_j["trainable"])).items()}
    err = {}
    for k, v in model.flat_params().items():
        assert v.dtype == torch.float32, k
        moved = np.linalg.norm(final_j[k] - init[k])
        diff = np.linalg.norm(to_np32(v) - final_j[k])
        err[k] = diff / moved if moved else float(diff > 0)
    return losses, err


@pytest.mark.parametrize("name", ["fp32", "bf16_hybrid", "bf16", "fp16"])
@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_steps_under_each_policy_match_jax(name, kind):
    """Two steps under each policy on fp32 masters against the jitted JAX
    step with the same policy: the loss each step and every master
    parameter's update, at ``STEP_TOL``; the masters stay fp32."""
    losses, err = _steps_vs_jax(name, kind)
    loss_tol, update_tol = STEP_TOL[name]
    for t, j in losses:
        assert abs(t / j - 1.0) <= loss_tol, (losses, name)
    assert max(err.values()) <= update_tol, err


def test_policy_gradients_reach_the_fp32_masters():
    """Under the bf16 policy the masters and their gradient buffers stay
    fp32, every leaf gets a gradient through the cast, and the per-layer
    views of the stacked leaves take none (the step never reads them)."""
    jcfg, tcfg = small_configs("gpt2", context_length=64)
    _, np_params = jax_params(jcfg, seed=3)
    model, state, step = _port(tcfg, np_params, tprec.get_policy("bf16"))
    before = {k: v.clone() for k, v in model.flat_params().items()}
    step(state, _port_feed(_batches(jcfg, 1)[0]))
    for k, g in state.grads.items():
        assert g.dtype == torch.float32 and state.params[k].dtype == torch.float32
        assert state.params[k].grad is g
        assert torch.count_nonzero(g) > 0, k
        assert not torch.equal(model.stacked[k], before[k]), k
    assert all(p.grad is None for p in model.parameters())


# ---------------------------------------------------------------------------
# fp16 dynamic loss scaling (the cases of tests/test_precision_scaling.py)
# ---------------------------------------------------------------------------

def _tiny(policy, peak_lr=5e-4):
    jcfg, tcfg = small_configs("gpt2", vocab_size=128, context_length=32,
                               emb_dim=32, n_heads=2, n_kv_groups=2,
                               hidden_dim=64)
    _, np_params = jax_params(jcfg, seed=0)
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(peak_lr, 1e-5, 1e-6, 3, 60))
    state = tts.init_train_state(model, opt, policy=policy)
    rng = np.random.default_rng(0)
    batch = {"inputs": torch.from_numpy(rng.integers(0, 128, (8, 32))),
             "targets": torch.from_numpy(rng.integers(0, 128, (8, 32))),
             "weights": torch.ones(8, 32)}
    return tcfg, state, tts.make_train_step(tcfg, opt, policy=policy), batch


def test_fp16_policy_trains_and_converges():
    policy = tprec.get_policy("fp16")
    _, state, step, batch = _tiny(policy, peak_lr=5e-3)
    assert state.loss_scale == 2.0 ** 15
    losses = []
    for _ in range(25):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        assert m["skipped"] == 0
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, "fp16 training did not converge"


def test_fp16_overflow_skips_step_and_halves_scale():
    """inf logits -> inf loss: the step keeps every parameter and the
    optimizer state (its count too), halves the scale, and still counts
    the step."""
    _, state, step, batch = _tiny(tprec.get_policy("fp16"))
    with torch.no_grad():
        state.params["head/weight"].add_(1e5)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    state, m = step(state, batch)
    assert m["skipped"] == 1 and m["loss_scale"] == 2.0 ** 14
    assert state.loss_scale == 2.0 ** 14 and state.growth_count == 0
    assert state.step == 1 and state.opt_state.count == 0
    for k, v in state.params.items():
        np.testing.assert_array_equal(bits(v), bits(before[k]), err_msg=k)
        np.testing.assert_array_equal(bits(state.opt_state.mu[k]), bits(mu[k]))


def test_fp16_scale_grows_after_finite_streak():
    policy = dataclasses.replace(tprec.get_policy("fp16"), init_loss_scale=8.0,
                                 scale_growth_interval=2)
    _, state, step, batch = _tiny(policy)
    state, m = step(state, batch)
    assert m["loss_scale"] == 8.0          # a streak of 1: no growth
    state, m = step(state, batch)
    assert m["loss_scale"] == 16.0         # a streak of 2: doubled
    assert state.growth_count == 0


# ---------------------------------------------------------------------------
# fp16 checkpoints across the two packages
# ---------------------------------------------------------------------------

def _jax_flat(tree):
    return {jckpt._path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_fp16_checkpoint_resumes_across_the_packages(tmp_path):
    """An fp16-policy state after two steps, with its loss scale moved off
    the initial one: the port's checkpoint loads in JAX and the JAX one in
    the port, every leaf bit-equal (loss_scale and growth_count at the JAX
    paths); a third step from the restored states agrees at the fp16
    bounds."""
    name = "fp16"
    jcfg, tcfg = small_configs("gpt2", context_length=64)
    params, np_params = jax_params(jcfg, seed=3)
    batches = _batches(jcfg, 3)
    model, state_t, step_t = _port(tcfg, np_params, tprec.get_policy(name))
    state_j, step_j = _jax(jcfg, params, jprec.get_policy(name))
    for x in batches[:2]:
        state_t, _ = step_t(state_t, _port_feed(x))
        state_j, _ = step_j(state_j, _jax_feed(x))
    state_t.loss_scale, state_t.growth_count = 2.0 ** 13, 2
    state_j = dict(jax.device_get(state_j),
                   loss_scale=jnp.asarray(2.0 ** 13, jnp.float32),
                   growth_count=jnp.asarray(2, jnp.int32))

    port_ck, jax_ck = str(tmp_path / "port"), str(tmp_path / "jax")
    save_checkpoint(port_ck, tts.checkpoint_tree(state_t), {"global_step": 2})
    jckpt.save_checkpoint(jax_ck, state_j, extra_metadata={"global_step": 2})

    template, step_j2 = _jax(jcfg, params, jprec.get_policy(name))
    loaded_j = jckpt.load_checkpoint(port_ck, template)
    flat = _jax_flat(loaded_j)
    for k, v in tts.checkpoint_tree(state_t).items():
        np.testing.assert_array_equal(bits(flat[k]), bits(v), err_msg=k)
    assert float(flat["loss_scale"]) == 2.0 ** 13
    assert int(flat["growth_count"]) == 2

    _, other = jax_params(jcfg, seed=9)
    _, restored, step_t2 = _port(tcfg, other, tprec.get_policy(name))
    tts.restore_train_state(restored, jax_ck)
    assert (restored.loss_scale, restored.growth_count) == (2.0 ** 13, 2)
    assert restored.step == 2 and restored.opt_state.count == 2
    want = _jax_flat(state_j)
    for k, v in tts.checkpoint_tree(restored).items():
        if k != "rng":
            np.testing.assert_array_equal(bits(v), bits(want[k]), err_msg=k)

    _, mj = step_j2(loaded_j, _jax_feed(batches[2]))
    _, mt = step_t2(restored, _port_feed(batches[2]))
    assert abs(mt["loss"].item() / float(mj["loss"]) - 1.0) <= STEP_TOL[name][0]
    assert mt["loss_scale"] == float(mj["loss_scale"]) == 2.0 ** 13
    assert restored.growth_count == 3
