"""LoRA instruction finetuning in the port against the JAX package, on the
same weights (``params_from_jax``), the same adapter (``lora_from_jax``)
and the same numpy inputs:

  - the instruction data: ``InstructionDataset``, ``collate_batch`` and the
    ``InstructLoader`` batches in both templates, bit for bit;
  - the weighted losses, dense and chunked: the value within 1e-6 and the
    gradients (hidden states and head) within 1e-5 relative L2 of
    ``jax.grad``, all-zero weights included (loss and gradients exactly 0);
  - the unmerged adapter in ``forward(lora=)`` within 1e-5 of the JAX
    logits, and greedy ``generate(lora=)`` tokens equal to JAX's;
  - five LoRA train steps on LLaMA (dense loss) and GPT-2 (chunked loss),
    dropout 0, fp32: per-step losses and norms to 1e-5 relative, the final
    adapter to 1e-5 absolute (but for coordinates whose first gradient is
    fp32 noise, ``NOISE_FLOOR``), the base bit-unchanged; in bf16 at the
    bounds of ``tests/test_torch_training.py`` (``BF16_STEP_TOL``);
  - ``Trainer.finetune_model`` against the JAX ``Trainer`` on the same
    Alpaca file, with LoRA and on the whole model: losses, LRs, tokens and
    the sample texts;
  - the merged export read by the JAX loader, the adapter artifact by the
    JAX ``load_adapter``, and the CLI's flag checks against the JAX CLI's.
"""

import json
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu import args as jargs
from building_llm_from_scratch_tpu.data import instruct as jinstruct
from building_llm_from_scratch_tpu.data.tokenizers import ByteTokenizer as JByte
from building_llm_from_scratch_tpu.generate import generate as jgenerate
from building_llm_from_scratch_tpu.models import lora as jlora
from building_llm_from_scratch_tpu.models import transformer as jtf
from building_llm_from_scratch_tpu.ops import softmax_xent as jsx
from building_llm_from_scratch_tpu.training import checkpoint as jckpt
from building_llm_from_scratch_tpu.training.optim import (
    build_optimizer,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu.training.train_step import (
    cross_entropy_loss as jcross_entropy_loss,
    init_train_state as jinit_state,
    make_train_step as jmake_train_step,
)
from building_llm_from_scratch_tpu_torch import args as targs
from building_llm_from_scratch_tpu_torch.data import instruct as tinstruct
from building_llm_from_scratch_tpu_torch.data.tokenizers import ByteTokenizer
from building_llm_from_scratch_tpu_torch.generate import generate
from building_llm_from_scratch_tpu_torch.models import lora as tlora
from building_llm_from_scratch_tpu_torch.models import transformer as ttf
from building_llm_from_scratch_tpu_torch.ops import softmax_xent as tsx
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    flatten_tree,
    lora_from_jax,
    params_from_jax,
)
from test_torch_training import BF16_STEP_TOL
from torch_port_helpers import (
    bits,
    jax_params,
    make_jax_lora,
    small_configs,
    to_np32,
)

RANK, ALPHA = 4, 8.0


def alpaca_records(n: int, tmp_path) -> list:
    """``n`` records written by ``scripts/build_local_alpaca.py``."""
    path = tmp_path / "alpaca.json"
    runpy.run_path("scripts/build_local_alpaca.py")["main"](["", str(path), str(n)])
    return json.loads(path.read_text()), path


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["alpaca", "phi"])
def test_datasets_and_collate_equal_the_jax_ones(tmp_path, style):
    """Token ids and prompt lengths of every record, and the collate of
    rows that fit, rows truncated past T and a prompt longer than T."""
    records, _ = alpaca_records(12, tmp_path)
    records[3] = dict(records[3], input="")          # the template without input
    jd = jinstruct.InstructionDataset(records, JByte(), style=style)
    td = tinstruct.InstructionDataset(records, ByteTokenizer(), style=style)
    assert td.encoded_texts == jd.encoded_texts
    assert td.instruction_lengths == jd.instruction_lengths
    for T in (256, 160, 40):
        kw = dict(pad_token_id=256, allowed_max_length=T)
        jb = jinstruct.collate_batch([jd[i] for i in range(12)], **kw)
        tb = tinstruct.collate_batch([td[i] for i in range(12)], **kw)
        for a, b in zip(tb, jb):
            assert a.dtype == b.dtype and a.shape == b.shape == (12, T)
            np.testing.assert_array_equal(a, b)
    assert tinstruct.format_input(records[0]) == jinstruct.format_input(records[0])
    assert (tinstruct.format_input_phi(records[3])
            == jinstruct.format_input_phi(records[3]))


@pytest.mark.parametrize("batch_size", [2, 3])
def test_loader_batches_equal_the_jax_loaders(tmp_path, batch_size):
    """The 90/10 split, the shuffled train batches of two epochs, the
    validation batches and the epoch's step count."""
    records, path = alpaca_records(23, tmp_path)
    kw = dict(batch_size=batch_size, max_length=192, pad_token_id=256, seed=7)
    jl = jinstruct.InstructLoader(JByte(), **kw)
    tl = tinstruct.InstructLoader(ByteTokenizer(), **kw)
    assert (tl.get_total_steps_epoch([str(path)])
            == jl.get_total_steps_epoch([str(path)]) == 20 // batch_size)
    (jtr, jva), (ttr, tva) = jl.create_datasets(records), tl.create_datasets(records)
    assert (len(ttr), len(tva)) == (len(jtr), len(jva)) == (20, 3)
    for epoch in (0, 1):
        for shuffle, jds, tds in ((True, jtr, ttr), (False, jva, tva)):
            jb = list(jl.batches(jds, shuffle=shuffle, epoch=epoch))
            tb = list(tl.batches(tds, shuffle=shuffle, epoch=epoch))
            assert len(tb) == len(jb) == tl.num_batches(tds) > 0
            for a, b in zip(tb, jb):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the weighted losses
# ---------------------------------------------------------------------------

def loss_case(kind_w: str):
    r = np.random.default_rng(3)
    B, T, D, V = 2, 24, 32, 300
    h = r.standard_normal((B, T, D)).astype(np.float32)
    w = (0.1 * r.standard_normal((D, V))).astype(np.float32)
    t = r.integers(0, V, (B, T))
    weights = {"mask": (r.random((B, T)) < 0.4).astype(np.float32),
               "zeros": np.zeros((B, T), np.float32),
               "none": None}[kind_w]
    return h, w, t, weights


@pytest.mark.parametrize("weights", ["mask", "zeros", "none"])
@pytest.mark.parametrize("route", ["dense", "chunked"])
def test_weighted_losses_and_gradients_match_jax(route, weights):
    """sum(nll w) / max(sum(w), 1) and its gradients in the hidden states
    and the head against ``jax.value_and_grad`` of the JAX loss (1e-6 on the
    value, 1e-5 relative L2 on each gradient); all-zero weights give a zero
    loss and zero gradients in both."""
    h, w, t, wt = loss_case(weights)

    def jloss(h_, w_):
        wj = None if wt is None else jnp.asarray(wt)
        if route == "dense":
            logits = jnp.einsum("btd,dv->btv", h_, w_,
                                preferred_element_type=jnp.float32)
            return jcross_entropy_loss(logits, jnp.asarray(t), wj)
        return jsx.fused_cross_entropy_loss(h_, w_, jnp.asarray(t), wj, chunk=128)

    lj, (ghj, gwj) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                                              jnp.asarray(w))
    ht, wt_ = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (h, w))
    tw = None if wt is None else torch.from_numpy(wt)
    if route == "dense":
        lt = tts.cross_entropy_loss(ttf._head_logits(ht, wt_), torch.from_numpy(t), tw)
    else:
        lt = tsx.fused_cross_entropy_loss(ht, wt_, torch.from_numpy(t), tw, chunk=128)
    lt.backward()
    if weights == "zeros":
        assert lt.item() == float(lj) == 0.0
        assert not ht.grad.any() and not wt_.grad.any()
        assert not np.asarray(ghj).any() and not np.asarray(gwj).any()
        return
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    for a, b in ((ht.grad, ghj), (wt_.grad, gwj)):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) / np.linalg.norm(b) <= 1e-5


def test_masked_tokens_do_not_move_the_loss():
    """The JAX test's case: weights (1, 1, 0, 0) give the loss of the
    first two tokens alone."""
    r = np.random.default_rng(0)
    logits = torch.from_numpy(r.standard_normal((1, 4, 8)).astype(np.float32))
    targets = torch.tensor([[1, 2, 3, 4]])
    half = tts.cross_entropy_loss(logits, targets, torch.tensor([[1.0, 1, 0, 0]]))
    first = tts.cross_entropy_loss(logits[:, :2], targets[:, :2])
    assert abs(half.item() - first.item()) < 1e-6


# ---------------------------------------------------------------------------
# the unmerged adapter: forward and generate
# ---------------------------------------------------------------------------

def lora_pair(kind: str, dtype: str = "fp32", **kw):
    """(jcfg, tcfg, JAX params, JAX adapter, port model, port adapter)."""
    jcfg, tcfg = small_configs(kind, dtype=dtype, **kw)
    params, np_params = jax_params(jcfg, seed=2)
    lora = make_jax_lora(jcfg, params, seed=5, rank=RANK)
    model = params_from_jax(np_params, tcfg, "cpu")
    return jcfg, tcfg, params, lora, model, lora_from_jax(jax.device_get(lora),
                                                          tcfg, "cpu")


@pytest.mark.parametrize("kind", ["llama", "gpt2"])
def test_lora_forward_matches_jax(kind):
    """``forward(lora=)`` within 1e-5 of the JAX ``forward(lora=)``, and not
    within it of the base model (the adapter is visible)."""
    jcfg, tcfg, params, lora, model, tl = lora_pair(kind)
    x = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 40))
    s = ALPHA / RANK
    ref = np.asarray(jtf.forward(params, jcfg, jnp.asarray(x, jnp.int32),
                                 lora=lora, lora_scaling=s))
    got = ttf.forward(model, torch.from_numpy(x), lora=tl, lora_scaling=s)
    base = ttf.forward(model, torch.from_numpy(x))
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
    assert np.abs(base.numpy() - ref).max() > 1e-2 * scale


@pytest.mark.parametrize("prompt_len,max_new", [(5, 12), (30, 40)],
                         ids=["cached", "window"])
def test_lora_greedy_generate_matches_jax(prompt_len, max_new):
    jcfg, tcfg, params, lora, model, tl = lora_pair("llama", context_length=64)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, prompt_len))
    out_j = jgenerate(params, jcfg, ids, max_new, lora=lora, lora_alpha=ALPHA,
                      lora_rank=RANK)
    out_t = generate(model, ids, max_new, lora=tl, lora_alpha=ALPHA,
                     lora_rank=RANK)
    np.testing.assert_array_equal(out_t, np.asarray(out_j))
    assert not np.array_equal(generate(model, ids, max_new), out_t)


# ---------------------------------------------------------------------------
# LoRA train steps
# ---------------------------------------------------------------------------

def _lora_steps_vs_jax(kind, dtype, fused_xent, eps=1e-8, n=5):
    """``n`` LoRA train steps of the port and of the jitted JAX step on the
    same base, adapter and weighted batches. Returns (per-step relative
    errors of loss, grad_norm, update_norm; the initial, port and JAX
    adapters as fp32 numpy; the base's bits before and after)."""
    jcfg, tcfg, params, lora, model, tl = lora_pair(kind, dtype, context_length=64)
    init = {k: to_np32(v) for k, v in flatten_tree(jax.device_get(lora)).items()}
    base_before = {k: bits(v).copy() for k, v in model.flat_params().items()}
    sched_j = warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 3, 10)
    opt_j = build_optimizer(schedule=sched_j)
    state_j = jinit_state(lora, opt_j, jax.random.PRNGKey(0), frozen=params)
    step_j = jmake_train_step(jcfg, opt_j, lr_schedule=sched_j, lora_alpha=ALPHA,
                              lora_rank=RANK, use_fused_xent=fused_xent)
    opt_t = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 3, 10), eps=eps)
    state_t = tts.init_train_state(tl, opt_t, frozen=model)
    step_t = tts.make_train_step(tcfg, opt_t, use_fused_xent=fused_xent,
                                 lora_alpha=ALPHA, lora_rank=RANK)
    assert sorted(state_t.params) == sorted(init)
    assert not any(p.requires_grad for p in model.parameters())
    rng = np.random.default_rng(1)
    rel, grads1 = [], None
    for _ in range(n):
        x = rng.integers(0, jcfg.vocab_size, (2, 65))
        w = (rng.random((2, 64)) < 0.5).astype(np.float32)
        state_j, mj = step_j(state_j, {"inputs": jnp.asarray(x[:, :-1], jnp.int32),
                                       "targets": jnp.asarray(x[:, 1:], jnp.int32),
                                       "weights": jnp.asarray(w)})
        state_t, mt = step_t(state_t, {"inputs": torch.from_numpy(x[:, :-1]),
                                       "targets": torch.from_numpy(x[:, 1:]),
                                       "weights": torch.from_numpy(w)})
        rel.append([abs(mt[k].item() / float(mj[k]) - 1.0)
                    for k in ("loss", "grad_norm", "update_norm")])
        np.testing.assert_allclose(mt["lr"], float(mj["lr"]), rtol=1e-6)
        assert mt["tokens"] == int(mj["tokens"]) == 128
        if grads1 is None:
            grads1 = {k: to_np32(g).copy() for k, g in state_t.grads.items()}
    final_j = {k: to_np32(v) for k, v in
               flatten_tree(jax.device_get(state_j["trainable"])).items()}
    final_t = {k: to_np32(v) for k, v in state_t.params.items()}
    base_after = {k: bits(v) for k, v in model.flat_params().items()}
    return (np.asarray(rel), init, final_t, final_j, base_before, base_after,
            grads1)


#: a first-step gradient below this share of its leaf's largest is fp32
#: summation noise: Adam's first update there is g / (|g| + eps), noise
#: over noise, so the two packages move such a coordinate by different
#: fractions of the LR (measured: GPT-2's blocks/mlp/up/B[0, 0, 207], a
#: gradient of -6.7e-9 in JAX and -8.7e-9 here against a largest 0.053,
#: ends 1.37e-5 apart, every other coordinate within 6.2e-7)
NOISE_FLOOR = 1e-6


@pytest.mark.parametrize("kind,fused_xent", [("llama", False), ("gpt2", None)],
                         ids=["llama-dense", "gpt2-chunked"])
def test_lora_train_steps_match_jax(kind, fused_xent):
    """Five weighted LoRA steps, fp32: loss and grad_norm to 1e-5 relative
    and update_norm to 1e-4 every step; every A and B after the last step
    to 1e-5 absolute, both moved, except the coordinates whose first
    gradient sits at the noise floor (``NOISE_FLOOR``; fewer than one in a
    thousand of a leaf), which stay within the five steps' LR sum; the base
    bit-unchanged (the JAX ``test_lora_train_step_only_updates_adapters``)."""
    rel, init, final_t, final_j, before, after, grads1 = _lora_steps_vs_jax(
        kind, "fp32", fused_xent)
    assert rel[:, :2].max() <= 1e-5 and rel[:, 2].max() <= 1e-4, rel
    for k, v in final_t.items():
        g = np.abs(grads1[k])
        floor = g < NOISE_FLOOR * g.max()
        assert floor.mean() < 1e-3, (k, floor.sum())
        np.testing.assert_allclose(v[~floor], final_j[k][~floor], atol=1e-5,
                                   rtol=0, err_msg=k)
        assert np.abs(v - final_j[k]).max() <= 5 * 5e-4, k
        assert np.any(v != init[k]), k
    for k, b in before.items():
        np.testing.assert_array_equal(after[k], b, err_msg=k)


def _bf16_lora_errors(eps=1e-8):
    rel, init, final_t, final_j, before, after, _ = _lora_steps_vs_jax(
        "llama", "bf16", False, eps=eps)
    for k, b in before.items():
        np.testing.assert_array_equal(after[k], b, err_msg=k)
    upd = {k: np.linalg.norm(final_t[k] - ref) / np.linalg.norm(ref - init[k])
           for k, ref in final_j.items()}
    return list(rel.max(axis=0)) + [max(upd.values())]


def test_bf16_lora_train_steps_match_jax():
    """Five bf16 LoRA steps within ``BF16_STEP_TOL`` (loss, grad_norm,
    update_norm relative every step; each adapter leaf's total update in
    relative L2); Adam's eps at 1e-4, the pretraining tests' control, must
    fail them."""
    errors = _bf16_lora_errors()
    assert all(e <= t for e, t in zip(errors, BF16_STEP_TOL)), errors
    control = _bf16_lora_errors(eps=1e-4)
    assert any(e > t for e, t in zip(control, BF16_STEP_TOL)), control


def test_lora_eval_step_matches_the_merged_forward():
    """The eval step's loss is the dense weighted loss of the merged
    model's forward (the JAX eval step's route), and takes no gradients."""
    jcfg, tcfg, params, lora, model, tl = lora_pair("llama", context_length=64)
    state = tts.init_train_state(tl, topt.AdamW(lambda c: 0.0), frozen=model)
    x = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 65))
    w = np.zeros((2, 64), np.float32)
    w[:, 20:] = 1.0
    batch = {"inputs": torch.from_numpy(x[:, :-1]), "targets": torch.from_numpy(x[:, 1:]),
             "weights": torch.from_numpy(w)}
    loss = tts.make_eval_step(tcfg, lora_alpha=ALPHA, lora_rank=RANK)(state, batch)
    merged = tlora.merge_lora(model.flat_params(), tl, ALPHA, RANK)
    ref = tts.dense_loss(model, ttf.forward_hidden(
        ttf.Transformer(tcfg, merged), batch["inputs"]), batch["targets"], batch["weights"],
        head=merged["head/weight"])
    assert abs(loss.item() - ref.item()) <= 1e-6 * abs(ref.item())
    assert not any(g.any() for g in state.grads.values())


# ---------------------------------------------------------------------------
# the trainer, the exports and the CLI
# ---------------------------------------------------------------------------

def _finetune_both(tmp_path, monkeypatch, use_lora=True):
    from building_llm_from_scratch_tpu.training.trainer import Trainer as JTrainer
    from building_llm_from_scratch_tpu_torch.training.trainer import Trainer

    _, path = alpaca_records(40, tmp_path)
    jcfg, tcfg, params, lora, model, tl = lora_pair("llama", context_length=256)
    kw = dict(eval_freq=6, print_sample_iter=9, warmup_steps=2, seed=3)
    if use_lora:
        kw.update(lora_alpha=ALPHA, lora_rank=RANK)
    else:
        lora = tl = None
    jsamples = []
    orig = JTrainer.generate_and_print_sample

    def record(self, *a, **k):
        jsamples.append(orig(self, *a, **k))
        return jsamples[-1]

    monkeypatch.setattr(JTrainer, "generate_and_print_sample", record)
    jt = JTrainer(jcfg, params, JByte(), jinstruct.InstructLoader(
        JByte(), batch_size=2, max_length=256, pad_token_id=256, seed=3),
        output_dir=str(tmp_path / "jout"), save_ckpt_freq=10_000,
        warmup_sample=True, show_progress=False, lora_params=lora, **kw)
    jt.finetune_model([str(path)], n_epochs=1)
    tt = Trainer(tcfg, model, ByteTokenizer(), tinstruct.InstructLoader(
        ByteTokenizer(), batch_size=2, max_length=256, pad_token_id=256, seed=3),
        output_dir=str(tmp_path / "tout"), lora_params=tl, **kw)
    tt.finetune_model([str(path)], n_epochs=1)
    return jt, tt, jsamples, jcfg, tcfg, params


def test_full_finetune_matches_the_jax_trainer(tmp_path, monkeypatch):
    """``--finetune`` without LoRA: every parameter trains on the masked
    loss; losses (1e-5 relative), LRs and samples equal the JAX
    ``Trainer``'s."""
    jt, tt, jsamples, *_ = _finetune_both(tmp_path, monkeypatch, use_lora=False)
    assert tt.global_step == jt.global_step == 18 and not tt.use_lora
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-5)
    np.testing.assert_allclose(tt.val_losses, jt.val_losses, rtol=1e-5)
    np.testing.assert_allclose(tt.track_lrs, jt.track_lrs, rtol=1e-6)
    assert tt.samples == jsamples


def test_finetune_model_matches_the_jax_trainer(tmp_path, monkeypatch):
    """``Trainer.finetune_model`` against the JAX ``Trainer`` on the same
    Alpaca file, base and adapter: steps, train/val losses (1e-5
    relative), LRs, tokens seen, and the warm-up and cadence samples (the
    adapter applied unmerged) equal; the base bit-unchanged. Then the
    merged export, read by the JAX loader, equals the port's merge bit for
    bit and the JAX ``merge_lora`` to 1e-6; the adapter artifact loads in
    JAX with its rank, alpha and fingerprint."""
    jt, tt, jsamples, jcfg, tcfg, params = _finetune_both(tmp_path, monkeypatch)
    assert tt.global_step == jt.global_step == 18
    assert len(tt.train_losses) == len(jt.train_losses) == 3
    np.testing.assert_allclose(tt.train_losses, jt.train_losses, rtol=1e-5)
    np.testing.assert_allclose(tt.val_losses, jt.val_losses, rtol=1e-5)
    assert min(tt.train_losses) > 0                 # supervised tokens remain
    np.testing.assert_allclose(tt.track_lrs, jt.track_lrs, rtol=1e-6)
    assert tt.track_tokens_seen == jt.track_tokens_seen
    assert tt.samples == jsamples and len(jsamples) == 3
    for k, v in flatten_tree(jax.device_get(params)).items():
        np.testing.assert_array_equal(bits(tt.model.stacked[k]), bits(v), err_msg=k)

    export = tt.export_final("model_pg_final.npz")
    loaded = flatten_tree(jax.device_get(jckpt.load_exported_params(export, params)))
    merged_t = tt._full_params()
    merged_j = flatten_tree(jax.device_get(jlora.merge_lora(
        jax.device_get(jt.state["frozen"]), jax.device_get(jt.state["trainable"]),
        ALPHA, RANK)))
    for k, v in loaded.items():
        np.testing.assert_array_equal(bits(v), bits(merged_t[k]), err_msg=k)
        np.testing.assert_allclose(v, merged_j[k], atol=1e-6, rtol=0, err_msg=k)
    art = tt.export_adapter(str(tmp_path / "sft.npz"))
    jtree, meta = jlora.load_adapter(art)
    assert (meta["rank"], meta["alpha"]) == (RANK, ALPHA)
    assert meta["fingerprint"] == jlora.adapter_fingerprint(jcfg)
    for k, v in flatten_tree(jax.device_get(jtree)).items():
        np.testing.assert_array_equal(bits(v), bits(tt.state.params[k]), err_msg=k)


def test_trainer_refuses_a_half_lora(tmp_path):
    from building_llm_from_scratch_tpu_torch.training.trainer import Trainer

    _, tcfg, _, _, model, tl = lora_pair("llama")
    with pytest.raises(ValueError, match="together"):
        Trainer(tcfg, model, ByteTokenizer(), None, lora_params=tl)
    with pytest.raises(ValueError, match="lora_alpha"):
        Trainer(tcfg, model, ByteTokenizer(), None, lora_params=tl, lora_rank=RANK)
    trainer = Trainer(tcfg, model, ByteTokenizer(), None)
    with pytest.raises(ValueError, match="LoRA run"):
        trainer.export_adapter(str(tmp_path / "x.npz"))


TRAIN_BASE = ["--mode", "train", "--model", "llama3_2", "--num_params", "1B",
              "--debug", "--byte_tokenizer"]


@pytest.mark.parametrize("extra", [
    ["--finetune"],
    ["--dataset", "alpaca"],
    ["--use_lora", "--lora_rank", "0"],
    ["--save_adapter", "a.npz"],
    ["--finetune", "--dataset", "alpaca", "--use_lora", "--save_adapter", "a.npz"],
    ["--finetune", "--dataset", "alpaca", "--lora_rank", "8", "--lora_alpha", "16"],
])
def test_finetune_flag_checks_match_the_jax_cli(tmp_path, extra):
    """The JAX CLI's finetune and LoRA checks: each command line is refused
    by both with the same message, or taken by both with the same values
    (and the JAX defaults: rank 64, alpha 32)."""
    argv = TRAIN_BASE + ["--data_dir", str(tmp_path)] + extra
    errors = []
    for get_args in (jargs.get_args, targs.get_args):
        try:
            a = get_args(argv)
            errors.append(None)
            vals = [(a.finetune, a.dataset, a.use_lora, a.lora_rank, a.lora_alpha,
                     a.save_adapter)]
            errors[-1] = vals
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    if extra[-1] == "a.npz" and len(extra) > 2:
        assert errors[1][0][3:5] == (64, 32)


def test_finetune_cli_runs_and_serves_its_adapter(tmp_path):
    """``--finetune --dataset alpaca --use_lora --save_adapter`` on a
    ``build_local_alpaca.py`` file, on the CPU: the merged export (the base
    plus the adapter's merge) and the adapter artifact are written, and
    ``--mode serve --serve_adapters`` serves that adapter."""
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        load_exported_params,
    )

    data = tmp_path / "data"
    data.mkdir()
    alpaca_records(30, data)
    art = str(tmp_path / "A.npz")
    trainer = tmain.run(TRAIN_BASE + [
        "--finetune", "--dataset", "alpaca", "--use_lora", "--lora_rank", "8",
        "--save_adapter", art, "--device", "cpu", "--data_dir", str(data),
        "--output_dir", str(tmp_path / "out"), "--n_epochs", "1",
        "--batch_size", "4", "--eval_freq", "3"])
    assert trainer.global_step == 27 // 4 and trainer.use_lora
    tree, meta = tlora.load_adapter(art)
    assert (meta["rank"], meta["alpha"]) == (8, 32.0)
    exported = load_exported_params(str(tmp_path / "out" / "model_pg_final.npz"),
                                    trainer.cfg, "cpu").flat_params()
    for k, v in trainer._full_params().items():
        assert torch.equal(exported[k], v), k
    req = tmp_path / "req.jsonl"
    req.write_text(json.dumps({"prompt_ids": [1, 2, 3], "max_new_tokens": 3,
                               "adapter": "a"}) + "\n")
    out = tmp_path / "served.jsonl"
    eng = tmain.run(["--mode", "serve", "--model", "llama3_2", "--num_params", "1B",
                     "--debug", "--device", "cpu", "--serve_prompts", str(req),
                     "--serve_out", str(out), "--serve_adapters", f"a={art}"])
    rec = json.loads(out.read_text())
    assert rec["adapter"] == "a" and len(rec["token_ids"]) == 3
    assert eng.stats()["per_adapter"]["a"]["finished"] == 1
