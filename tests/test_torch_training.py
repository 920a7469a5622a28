"""The port's training path against the JAX package on the same weights
(``params_from_jax`` / one JAX ``.npz`` export) and the same numpy data:
the LR schedule and optimizer against optax, the pretraining loader's
batches, train steps against ``make_train_step(jit=True)``, greedy
``generate()``, both CLIs end to end, and the export format.

Tolerances in fp32 (stated per check): the schedule and every integer
(batches, tokens, sampled ids) exactly or to 1e-6 relative; losses and
gradient norms to 1e-5 relative (the same math in another summation
order); parameters after five Adam steps to 1e-5 absolute (2% of one step
at the peak LR of 5e-4), because Adam divides each coordinate by its own
gradient scale, so a coordinate whose gradient sits near the fp32 noise
floor moves by a visibly different fraction of the LR in the two packages
(typically one coordinate in 10^5 differs by more than 2e-6).

In bf16 (the dtype the card trains in): the optimizer fed the same bf16
gradients is bit-exact with optax over 12 updates; one step's gradients
agree with ``jax.grad`` to 2e-2 relative L2 per leaf (about 0.9e-2 is
measured: bf16 roundings of activations at other places in the two
graphs); and five train steps agree to 1e-3 relative in the loss (4e-5
measured) and 1e-2 (2.5 bf16 units in the last place) in the bf16
grad_norm and update_norm (equal in the measured runs), with each leaf's
total update within 0.15 relative L2 (up to 0.066 measured, on the
embedding). Each bf16 bound has a control, a deliberately wrong port, that
fails it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.configs import get_config as jget_config
from building_llm_from_scratch_tpu.data.pretrain import PretrainLoader as JLoader
from building_llm_from_scratch_tpu.data.tokenizers import ByteTokenizer as JByte
from building_llm_from_scratch_tpu.generate import generate as jgenerate
from building_llm_from_scratch_tpu.models import init_params as jinit
from building_llm_from_scratch_tpu.models.transformer import (
    forward_hidden as jforward_hidden,
)
from building_llm_from_scratch_tpu.training import checkpoint as jckpt
from building_llm_from_scratch_tpu.training.optim import (
    build_optimizer,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu.training.train_step import (
    init_train_state as jinit_state,
    make_loss_fns,
    make_train_step as jmake_train_step,
)
from building_llm_from_scratch_tpu_torch.models import transformer as ttf
from building_llm_from_scratch_tpu_torch.data.pretrain import PretrainLoader
from building_llm_from_scratch_tpu_torch.data.tokenizers import ByteTokenizer
from building_llm_from_scratch_tpu_torch.generate import generate
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    export_params,
    flatten_tree,
    load_exported_params,
    params_from_jax,
)
from torch_port_helpers import bits, jax_params, small_configs, to_np32

TEXT = ("Every effort moves you closer to mastery. " * 12
        + "A quick brown fox jumps over the lazy dog. " * 6)


def _cli_data(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    (d / "corpus.txt").write_text(TEXT)
    jcfg = jget_config("llama3_2", "1B", dtype="fp32", debug=True)
    export = str(tmp_path / "init.npz")
    jckpt.export_params(export, jinit(jcfg, jax.random.PRNGKey(5)))
    return str(d), export


def test_both_clis_train_alike(tmp_path, monkeypatch):
    """The JAX and the port's ``main.run`` with the same flags and the same
    initial weights: the same number of steps, the same train/val loss
    history (1e-5 relative), the same greedy warm-up sample, and the port's
    export read back by the JAX loader."""
    from building_llm_from_scratch_tpu import main as jmain
    from building_llm_from_scratch_tpu.training.trainer import Trainer as JTrainer
    from building_llm_from_scratch_tpu_torch import main as tmain

    data_dir, export = _cli_data(tmp_path)
    flags = ["--model", "llama3_2", "--num_params", "1B", "--debug",
             "--byte_tokenizer", "--data_type", "fp32", "--n_epochs", "1",
             "--batch_size", "4", "--eval_freq", "4",
             "--print_sample_iter", "1000", "--warmup_steps", "2",
             "--init_params_from", export, "--data_dir", data_dir]
    jsamples = []
    orig = JTrainer.generate_and_print_sample

    def record(self, *a, **kw):
        jsamples.append(orig(self, *a, **kw))
        return jsamples[-1]

    monkeypatch.setattr(JTrainer, "generate_and_print_sample", record)
    # the JAX run's loss plot (matplotlib) is not compared; skip drawing it
    monkeypatch.setattr(jmain, "plot_losses", lambda *a, **kw: None)
    jt = jmain.run(flags + ["--output_dir", str(tmp_path / "jout"),
                            "--save_ckpt_freq", "1000"])
    tt = tmain.run(flags + ["--output_dir", str(tmp_path / "tout"),
                            "--device", "cpu"])
    assert tt.global_step == jt.global_step >= 8
    assert len(tt.train_losses) == len(jt.train_losses) >= 2
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-5)
    np.testing.assert_allclose(tt.val_losses, jt.val_losses, rtol=1e-5)
    assert np.isfinite(tt.val_losses).all()
    assert tt.track_tokens_seen == jt.track_tokens_seen
    np.testing.assert_allclose(tt.track_lrs, jt.track_lrs, rtol=1e-6)
    assert tt.samples[0] == jsamples[0]
    assert [m["step"] for m in tt.step_metrics] == list(range(1, tt.global_step + 1))
    jcfg = jget_config("llama3_2", "1B", dtype="fp32", debug=True)
    loaded = jckpt.load_exported_params(
        str(tmp_path / "tout" / "model_pg_final.npz"),
        jinit(jcfg, jax.random.PRNGKey(0)))
    for k, v in flatten_tree(jax.device_get(loaded)).items():
        np.testing.assert_array_equal(bits(v), bits(tt.model.stacked[k]),
                                      err_msg=k)


def test_schedule_and_optimizer_match_optax():
    """12 updates of a small tree with gradients scaled so clipping both
    triggers and does not; params after every update and the LR."""
    sched_j = warmup_cosine_schedule(5e-3, 1e-4, 1e-5, 4, 12)
    opt_j = build_optimizer(schedule=sched_j, weight_decay=0.1)
    sched_t = topt.warmup_cosine_schedule(5e-3, 1e-4, 1e-5, 4, 12)
    opt_t = topt.AdamW(sched_t, weight_decay=0.1)
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((8, 5)).astype(np.float32)},
            "b": rng.standard_normal((7,)).astype(np.float32)}
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    state_j = opt_j.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in flatten_tree(tree).items()}
    state_t = opt_t.init(pt)
    clipped = []
    for i in range(12):
        scale = 3.0 if i % 3 == 0 else 0.05
        g = {"a": {"w": scale * rng.standard_normal((8, 5)).astype(np.float32)},
             "b": scale * rng.standard_normal((7,)).astype(np.float32)}
        upd, state_j = opt_j.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    state_j, pj)
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, upd)
        m = opt_t.step(pt, {k: torch.from_numpy(v.copy())
                            for k, v in flatten_tree(g).items()}, state_t)
        clipped.append(m["grad_norm"].item() >= 1.0)
        np.testing.assert_allclose(m["lr"], float(sched_j(i)), rtol=1e-6)
        for k, v in flatten_tree(jax.device_get(pj)).items():
            np.testing.assert_allclose(pt[k].numpy(), v, atol=1e-6, rtol=1e-6)
    assert any(clipped) and not all(clipped)


def _bf16_optimizer_mismatch(control):
    """Fraction of bf16 parameter, mu and nu bits that differ from optax
    after each of 12 updates of the same bf16 tree with the same bf16
    gradients (clipping triggered on every third update)."""
    bf = jnp.bfloat16
    sched_j = warmup_cosine_schedule(5e-3, 1e-4, 1e-5, 4, 12)
    opt_j = build_optimizer(schedule=sched_j, weight_decay=0.1)
    opt_t = topt.AdamW(topt.warmup_cosine_schedule(5e-3, 1e-4, 1e-5, 4, 12),
                       weight_decay=0.1)
    rng = np.random.default_rng(0)

    def tree(scale=1.0):
        return {"a": {"w": jnp.asarray(scale * rng.standard_normal((64, 50)), bf)},
                "b": jnp.asarray(scale * rng.standard_normal((70,)), bf)}

    def to_t(t):
        return {k: torch.from_numpy(to_np32(v)).to(torch.bfloat16)
                for k, v in flatten_tree(jax.device_get(t)).items()}

    def mismatch(jt, tt):
        return np.concatenate([(bits(v) != bits(tt[k].to(torch.bfloat16))).ravel()
                               for k, v in flatten_tree(jax.device_get(jt)).items()]).mean()

    pj = tree()
    state_j = opt_j.init(pj)
    pt = to_t(pj)
    state_t = opt_t.init(pt)
    if control == "fp32_moments":
        state_t.mu = {k: v.float() for k, v in state_t.mu.items()}
        state_t.nu = {k: v.float() for k, v in state_t.nu.items()}
    out = []
    for i in range(12):
        g = tree(3.0 if i % 3 == 0 else 0.05)
        upd, state_j = opt_j.update(g, state_j, pj)
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, upd)
        m = opt_t.step(pt, to_t(g), state_t)
        assert m["grad_norm"].dtype == torch.bfloat16
        out.append((mismatch(pj, pt), mismatch(state_j[1].mu, state_t.mu),
                    mismatch(state_j[1].nu, state_t.nu)))
    return np.max(out)


@pytest.mark.parametrize("control", [None, "unrounded_constants",
                                     "fp32_moments"])
def test_bf16_optimizer_is_bit_exact_with_optax(monkeypatch, control):
    """bf16 parameters, moments and gradients: the port's update equals
    optax's bit for bit (parameters and both moments, every update). The
    controls must break it: the constants left unrounded (b2 0.999 where
    bf16 optax has 1.0), or moments kept in fp32."""
    if control == "unrounded_constants":
        monkeypatch.setattr(topt, "_rounded", lambda x, dtype: x)
    worst = _bf16_optimizer_mismatch(control)
    if control is None:
        assert worst == 0.0
    else:
        assert worst > 0.01, worst


@pytest.mark.parametrize("stride", [16, 8])
def test_loader_batches_equal_the_jax_loaders(tmp_path, stride):
    path = tmp_path / "corpus.txt"
    path.write_text(TEXT)
    kw = dict(batch_size=3, max_length=16, stride=stride, train_ratio=0.9,
              seed=7)
    jl, tl = JLoader(JByte(), **kw), PretrainLoader(ByteTokenizer(), **kw)
    assert (tl.get_total_steps_epoch([str(path)])
            == jl.get_total_steps_epoch([str(path)]) > 0)
    jtr, jva = jl.create_datasets_for_file(str(path), "<|endoftext|>")
    ttr, tva = tl.create_datasets_for_file(str(path), "<|endoftext|>")
    for epoch in (0, 1):
        for shuffle, (jd, td) in ((True, (jtr, ttr)), (False, (jva, tva))):
            jb = list(jl.batches(jd, shuffle=shuffle, epoch=epoch))
            tb = list(tl.batches(td, shuffle=shuffle, epoch=epoch))
            assert len(jb) == len(tb) > 0
            for (ji, jt), (ti, tt) in zip(jb, tb):
                np.testing.assert_array_equal(ji, ti)
                np.testing.assert_array_equal(jt, tt)


def _head_bwd_off_by_one(ctx, g):
    """A wrong head backward (the control): the weight gradient leaves out
    the last token."""
    x2, w = ctx.saved_tensors
    g = g.to(x2.dtype)
    return g @ w.t(), x2[:-1].t() @ g[:-1]


GRAD_TOL = {"fp32": (1e-6, 1e-5), "bf16": (1e-4, 2e-2)}   # loss rel, leaf rel L2


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("control", [False, True])
def test_gradients_match_jax_grad(monkeypatch, dtype, control):
    """One forward/backward at T 256 (the fused twins): the loss and every
    leaf's gradient against ``jax.value_and_grad`` of the JAX dense loss on
    the same weights (GRAD_TOL). The control, a head backward that leaves
    out the last token, must fail the head's bound."""
    jcfg, tcfg = small_configs("llama", dtype=dtype, context_length=256)
    params, np_params = jax_params(jcfg)
    x = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 257))
    loss_impl = make_loss_fns(jcfg, use_fused_xent=False)[0]

    def jloss(p):
        hidden = jforward_hidden(p, jcfg, jnp.asarray(x[:, :-1], jnp.int32))
        return loss_impl(p, hidden, jnp.asarray(x[:, 1:], jnp.int32), None)

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(params)
    if control:
        monkeypatch.setattr(ttf._HeadLogits, "backward",
                            staticmethod(_head_bwd_off_by_one))
    model = params_from_jax(np_params, tcfg, "cpu")
    state = tts.init_train_state(model, topt.AdamW(lambda count: 0.0))
    hidden = ttf.forward_hidden(model, torch.from_numpy(x[:, :-1]))
    loss = tts.dense_loss(model, hidden, torch.from_numpy(x[:, 1:]))
    loss.backward()
    loss_tol, grad_tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=loss_tol)
    err = {}
    for k, v in flatten_tree(jax.device_get(grads_j)).items():
        ref = to_np32(v)
        assert state.grads[k].dtype == model.stacked[k].dtype, k
        err[k] = np.linalg.norm(to_np32(state.grads[k]) - ref) / np.linalg.norm(ref)
    if control:
        assert err["head/weight"] > grad_tol, err
    else:
        assert max(err.values()) <= grad_tol, err


def _train_steps_vs_jax(context, dtype, eps=1e-8, kind="llama", fused_xent=False):
    """Five steps of the port's train step (Adam's ``eps`` as given) and of
    the jitted JAX step on the same weights and batches, both with the
    chunked cross entropy or both with the dense one. Returns the per-step
    relative errors of loss, grad_norm and update_norm, and the initial,
    port and JAX parameters after the last step (fp32 numpy)."""
    jcfg, tcfg = small_configs(kind, dtype=dtype, context_length=context)
    params, np_params = jax_params(jcfg)
    init = {k: to_np32(v) for k, v in flatten_tree(np_params).items()}
    sched_j = warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 3, 10)
    opt_j = build_optimizer(schedule=sched_j)
    state_j = jinit_state(params, opt_j, jax.random.PRNGKey(0))
    step_j = jmake_train_step(jcfg, opt_j, lr_schedule=sched_j,
                              use_fused_xent=fused_xent)
    model = params_from_jax(np_params, tcfg, "cpu")
    opt_t = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 3, 10),
                       eps=eps)
    state_t = tts.init_train_state(model, opt_t)
    step_t = tts.make_train_step(tcfg, opt_t, use_fused_xent=fused_xent)
    rng = np.random.default_rng(1)
    rel = []
    for _ in range(5):
        x = rng.integers(0, jcfg.vocab_size, (2, context + 1))
        state_j, mj = step_j(state_j, {
            "inputs": jnp.asarray(x[:, :-1], jnp.int32),
            "targets": jnp.asarray(x[:, 1:], jnp.int32)})
        state_t, mt = step_t(state_t, {"inputs": torch.from_numpy(x[:, :-1]),
                                       "targets": torch.from_numpy(x[:, 1:])})
        rel.append([abs(mt[k].item() / float(mj[k]) - 1.0)
                    for k in ("loss", "grad_norm", "update_norm")])
        np.testing.assert_allclose(mt["lr"], float(mj["lr"]), rtol=1e-6)
        assert mt["tokens"] == int(mj["tokens"])
    assert state_t.step == 5
    final_j = flatten_tree(jax.device_get(state_j["trainable"]))
    final_t = {k: to_np32(v) for k, v in model.flat_params().items()}
    return np.asarray(rel), init, final_t, {k: to_np32(v) for k, v in final_j.items()}


#: bf16 bounds of five train steps: loss, grad_norm, update_norm (relative,
#: every step) and each leaf's total update (relative L2)
BF16_STEP_TOL = (1e-3, 1e-2, 1e-2, 0.15)


def _bf16_step_errors(context, eps=1e-8, **kw):
    rel, init, final_t, final_j = _train_steps_vs_jax(context, "bf16", eps, **kw)
    upd = {}
    for k, ref in final_j.items():
        dj = ref - init[k]
        if np.any(dj):
            upd[k] = np.linalg.norm(final_t[k] - ref) / np.linalg.norm(dj)
        else:      # a leaf the five updates leave in place (bf16 norm scales)
            upd[k] = float(np.any(final_t[k] != ref))
    return list(rel.max(axis=0)) + [max(upd.values())]


# T 64 takes the xla path, T 256 the fused twins
@pytest.mark.parametrize("context,dtype", [(64, "fp32"), (256, "fp32"),
                                           (64, "bf16"), (256, "bf16")],
                         ids=["64", "256", "64-bf16", "256-bf16"])
def test_train_steps_match_jax(context, dtype):
    """Five steps of the port's train step against the jitted JAX step on
    the same weights and batches: loss, grad_norm, update_norm and lr per
    step, and every parameter after the last step. In bf16 the bounds are
    BF16_STEP_TOL, and a control, Adam's eps at 1e-4 (the effect of eps
    inside the square root on coordinates with small second moments), must
    fail them."""
    if dtype == "bf16":
        errors = _bf16_step_errors(context)
        assert all(e <= t for e, t in zip(errors, BF16_STEP_TOL)), errors
        control = _bf16_step_errors(context, eps=1e-4)
        assert any(e > t for e, t in zip(control, BF16_STEP_TOL)), control
        return
    rel, _, final_t, final_j = _train_steps_vs_jax(context, dtype)
    assert rel[:, :2].max() <= 1e-5 and rel[:, 2].max() <= 1e-4, rel
    for k, v in final_t.items():
        np.testing.assert_allclose(v, final_j[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("prompt_len,max_new,eos", [(5, 12, None),   # cached
                                                    (30, 40, None),  # window
                                                    (5, 12, "first")])
def test_greedy_generate_matches_jax(prompt_len, max_new, eos):
    jcfg, tcfg = small_configs("llama", context_length=64)
    params, np_params = jax_params(jcfg, seed=2)
    model = params_from_jax(np_params, tcfg, "cpu")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                            (2, prompt_len))
    eos_id = None
    if eos == "first":    # row 0 stops at its third token, row 1 goes on
        eos_id = int(jgenerate(params, jcfg, ids, 3)[0, prompt_len + 2])
    out_j, n_j = jgenerate(params, jcfg, ids, max_new, eos_id=eos_id,
                           return_n_generated=True)
    out_t, n_t = generate(model, ids, max_new, eos_id=eos_id,
                          return_n_generated=True)
    np.testing.assert_array_equal(np.asarray(n_t), np.asarray(n_j))
    np.testing.assert_array_equal(out_t, np.asarray(out_j))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_export_is_read_by_the_jax_loader_bit_for_bit(tmp_path, dtype):
    jcfg, tcfg = small_configs("llama", dtype=dtype)
    _, np_params = jax_params(jcfg, seed=4)
    model = params_from_jax(np_params, tcfg, "cpu")
    path = export_params(str(tmp_path / "model.npz"), model)
    template = jinit(jcfg, jax.random.PRNGKey(9))
    loaded = flatten_tree(jax.device_get(jckpt.load_exported_params(path,
                                                                    template)))
    back = load_exported_params(path, tcfg, "cpu").flat_params()
    for k, v in flatten_tree(np_params).items():
        assert loaded[k].dtype == v.dtype, k
        np.testing.assert_array_equal(bits(loaded[k]), bits(v), err_msg=k)
        np.testing.assert_array_equal(bits(back[k]), bits(v), err_msg=k)


@pytest.mark.parametrize("extra,error,match", [
    (["--fleet_jobs", "jobs.json"], SystemExit, None),
    (["--data_type", "fp16", "--mixed_precision", "bf16"], ValueError,
     "requires --mixed_precision fp16"),
    (["--grad_accum", "3"], ValueError, "divisible by --grad_accum"),
    (["--serve_replicas", "2"], SystemExit, None),
    (["--grad_accum", "2", "--mixed_precision", "bf16_hybrid"], ValueError,
     "does not compose"),
    (["--prefetch", "-1"], ValueError, "prefetch"),
    (["--mode", "finetune_fleet"], ValueError, "not ported"),
])
def test_train_cli_refuses_what_is_not_ported(tmp_path, capsys, extra, error,
                                              match):
    from building_llm_from_scratch_tpu_torch.args import get_args

    base = ["--mode", "train", "--model", "llama3_2", "--num_params", "1B",
            "--debug", "--byte_tokenizer", "--data_dir", str(tmp_path)]
    with pytest.raises(error, match=match):
        get_args(base + extra)
    if error is SystemExit:
        assert "ROADMAP queue 1" in capsys.readouterr().err


def test_train_needs_the_byte_tokenizer_and_a_data_dir(tmp_path):
    """A tokenizer source is --byte_tokenizer or --tokenizer_path; with
    neither, the flags parse and the run fails where the JAX package's
    offline run fails, at the tokenizer, naming --tokenizer_path."""
    from building_llm_from_scratch_tpu_torch.args import get_args
    from building_llm_from_scratch_tpu_torch.build_components import (
        build_components,
    )

    base = ["--model", "llama3_2", "--num_params", "1B", "--debug"]
    args = get_args(base + ["--data_dir", str(tmp_path), "--device", "cpu"])
    assert (args.byte_tokenizer, args.tokenizer_path) == (False, None)
    with pytest.raises(FileNotFoundError, match="--tokenizer_path"):
        build_components(args, torch.device("cpu"))
    with pytest.raises(FileNotFoundError):
        get_args(base + ["--byte_tokenizer", "--data_dir",
                         str(tmp_path / "missing")])
    args = get_args(base + ["--byte_tokenizer", "--data_dir", str(tmp_path)])
    assert (args.mode, args.device, args.lr, args.eval_freq) == (
        "train", "cuda", 5e-4, 10)
    args = get_args(base + ["--tokenizer_path", "t.model", "--tokenizer_cache_dir",
                            "c", "--data_dir", str(tmp_path)])
    assert (args.tokenizer_path, args.tokenizer_cache_dir) == ("t.model", "c")


def test_grad_buffers_are_slices_of_the_stacked_leaves():
    """Every parameter is a JAX leaf or a layer's view of one, and
    ``attach_grads`` points its gradient at the matching slice of one
    stacked buffer."""
    jcfg, tcfg = small_configs("llama")
    _, np_params = jax_params(jcfg)
    model = params_from_jax(np_params, tcfg, "cpu")
    grads = {k: torch.zeros_like(v) for k, v in model.stacked.items()}
    model.attach_grads(grads)
    names = {n for n, _, _ in model.leaves()}
    assert names == set(model.stacked) == set(flatten_tree(np_params))
    for name, l, p in model.leaves():
        g = grads[name] if l is None else grads[name][l]
        assert p.grad.data_ptr() == g.data_ptr()
        src = model.stacked[name] if l is None else model.stacked[name][l]
        assert p.data_ptr() == src.data_ptr()


# ---------------------------------------------------------------------------
# GPT-2 pretraining (learned positions, biases, layernorm, dropout, and the
# chunked cross entropy its width takes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gpt2_train_steps_match_jax(dtype):
    """A GPT-2-like model with ``drop_rate`` forced to 0 (T 256, the fused
    twins): five steps of the port's step against the JAX
    ``make_train_step``, both taking the chunked cross entropy at this
    width (JAX's own choice), at the LLaMA steps' tolerances."""
    if dtype == "bf16":
        errors = _bf16_step_errors(256, kind="gpt2", fused_xent=None)
        assert all(e <= t for e, t in zip(errors, BF16_STEP_TOL)), errors
        return
    rel, _, final_t, final_j = _train_steps_vs_jax(256, dtype, kind="gpt2",
                                                   fused_xent=None)
    assert rel[:, :2].max() <= 1e-5 and rel[:, 2].max() <= 1e-4, rel
    assert {"pos_emb/weight", "blocks/attn/bo", "blocks/mlp/b_up",
            "blocks/mlp/b_down", "blocks/norm1/bias", "final_norm/bias"} <= set(final_t)
    for k, v in final_t.items():
        np.testing.assert_allclose(v, final_j[k], atol=1e-5, rtol=0, err_msg=k)


def test_gpt2_gradients_reach_every_leaf():
    """One GPT-2 forward/backward (dropout 0, the chunked loss) against
    ``jax.grad`` of the JAX fused loss: every leaf's gradient, the position
    embedding, biases and layernorm biases included, lands in its stacked
    buffer within 1e-5 relative L2; a control that detaches the position
    embedding fails for that leaf."""
    jcfg, tcfg = small_configs("gpt2", context_length=256)
    params, np_params = jax_params(jcfg, seed=6)
    x = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 257))
    loss_impl = make_loss_fns(jcfg)[0]

    def jloss(p):
        hidden = jforward_hidden(p, jcfg, jnp.asarray(x[:, :-1], jnp.int32))
        return loss_impl(p, hidden, jnp.asarray(x[:, 1:], jnp.int32), None)

    grads_j = flatten_tree(jax.device_get(jax.jit(jax.grad(jloss))(params)))
    errs = []
    for control in (False, True):
        model = params_from_jax(np_params, tcfg, "cpu")
        state = tts.init_train_state(model, topt.AdamW(lambda count: 0.0))
        if control:
            model.pos_emb.requires_grad_(False)
        hidden = ttf.forward_hidden(model, torch.from_numpy(x[:, :-1]))
        tts.make_loss_fns(tcfg)(model, hidden, torch.from_numpy(x[:, 1:])).backward()
        errs.append({k: np.linalg.norm(to_np32(state.grads[k]) - to_np32(v))
                     / np.linalg.norm(to_np32(v)) for k, v in grads_j.items()})
    assert set(errs[0]) == set(model.stacked) and max(errs[0].values()) <= 1e-5, errs[0]
    assert errs[1]["pos_emb/weight"] > 0.5


def _gpt2_dropout_run(seed, steps=2, drop=0.1):
    jcfg, tcfg = small_configs("gpt2", context_length=256, drop_rate=drop)
    _, np_params = jax_params(jcfg, seed=8)
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    state = tts.init_train_state(model, opt, seed=seed)
    step = tts.make_train_step(tcfg, opt)
    rng = np.random.default_rng(3)
    losses = []
    for _ in range(steps):
        x = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 257)))
        state, m = step(state, {"inputs": x[:, :-1], "targets": x[:, 1:]})
        losses.append(m["loss"].item())
    return losses, {k: v.clone() for k, v in model.flat_params().items()}


@pytest.fixture
def deterministic_torch():
    """torch's deterministic algorithms: the CPU embedding backward
    (index_put with accumulation) sums in a thread-dependent order
    otherwise, whatever the dropout masks."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_gpt2_dropout_steps_are_seeded(deterministic_torch):
    """With dropout 0.1 two runs from one seed give the same losses and
    parameters bit for bit, another seed other ones, and both differ from
    the run without dropout."""
    a, pa = _gpt2_dropout_run(5)
    b, pb = _gpt2_dropout_run(5)
    c, pc = _gpt2_dropout_run(6)
    d, _ = _gpt2_dropout_run(5, drop=0.0)
    assert a == b and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert a[0] != c[0] and a[0] != d[0] and c[0] != d[0]
    assert any(not torch.equal(pa[k], pc[k]) for k in pa)


def test_gpt2_eval_is_deterministic_and_matches_jax():
    """The eval step of a dropout config (no dropout, the chunked loss)
    equals the JAX ``make_eval_step`` on the same weights to 1e-5."""
    from building_llm_from_scratch_tpu.training.train_step import (
        make_eval_step as jmake_eval_step,
    )

    jcfg, tcfg = small_configs("gpt2", context_length=256, drop_rate=0.1)
    params, np_params = jax_params(jcfg, seed=9)
    x = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 257))
    loss_j = jmake_eval_step(jcfg)({"trainable": params, "frozen": {}}, {
        "inputs": jnp.asarray(x[:, :-1], jnp.int32),
        "targets": jnp.asarray(x[:, 1:], jnp.int32)})
    model = params_from_jax(np_params, tcfg, "cpu")
    state = tts.init_train_state(model, topt.AdamW(lambda count: 0.0), seed=1)
    batch = {"inputs": torch.from_numpy(x[:, :-1]), "targets": torch.from_numpy(x[:, 1:])}
    loss = tts.make_eval_step(tcfg)(state, batch)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert loss.item() == tts.make_eval_step(tcfg)(state, batch).item()


def test_gpt2_cli_trains_with_dropout(tmp_path):
    """``--model GPT2 --debug --byte_tokenizer --device cpu`` (dropout 0.1):
    the run ends, its loss falls, and its export loads in the JAX loader
    bit for bit."""
    from building_llm_from_scratch_tpu_torch import main as tmain

    d = tmp_path / "data"
    d.mkdir()
    (d / "corpus.txt").write_text(TEXT * 2)
    tt = tmain.run(["--model", "GPT2", "--num_params", "124M", "--debug",
                    "--byte_tokenizer", "--device", "cpu", "--n_epochs", "1",
                    "--batch_size", "4", "--eval_freq", "5",
                    "--print_sample_iter", "1000", "--warmup_steps", "2",
                    "--data_dir", str(d), "--output_dir", str(tmp_path / "out")])
    assert tt.cfg.drop_rate == 0.1 and tt.global_step >= 10
    losses = [m["loss"] for m in tt.step_metrics]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert tt.train_losses[-1] < tt.train_losses[0]
    jcfg = jget_config("GPT2", "124M", dtype="fp32", debug=True)
    loaded = jckpt.load_exported_params(
        str(tmp_path / "out" / "model_pg_final.npz"),
        jinit(jcfg, jax.random.PRNGKey(0)))
    flat = flatten_tree(jax.device_get(loaded))
    assert set(flat) == set(tt.model.stacked)
    for k, v in flat.items():
        np.testing.assert_array_equal(bits(v), bits(tt.model.stacked[k]), err_msg=k)
