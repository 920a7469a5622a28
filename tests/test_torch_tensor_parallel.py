"""The port's tensor and sequence parallelism (``--shard_mode tp|tp_fsdp``,
``--sp``) in real gloo groups on the CPU (``tests/torch_dist_worker.py``),
against the JAX package's GSPMD step on a CPU mesh of the same shape.

Two groups serve every scenario: two ranks (tp on a (1, 1, 2) mesh: GPT-2
with an indivisible vocabulary, LLaMA with a divisible one, the
vocab-parallel loss, GPT-2 with dropout against one rank, the no-reduce
control, a tp checkpoint) and four ranks (tp_fsdp on (2, 1, 2), sp with
fsdp on (2, 2, 1), ring attention at sp 4 and, on (2, 2, 1), sp 2); sp
with bf16_hybrid runs on the two ranks (1, 2, 1): bf16 sums of two
partial gradients do not depend on their order, those of four do. The JAX references run in a process of their own
(``tests/torch_jax_refs.py``): a JAX sp training compile after another in
one process can abort inside XLA.

Tolerances:
  - against the JAX GSPMD step (fp32): per-step losses rtol 2e-4 atol
    2e-5 (the JAX sharding test's); final parameters within 1e-5 relative
    L2 (all leaves as one vector) and each leaf at rtol 2e-3 atol 2e-5;
    the no-reduce control fails the relative-L2 bound;
  - bf16_hybrid with sp against the JAX explicit step: losses as above,
    each leaf's difference within 1e-3 of its update (relative L2);
  - tp with dropout 0.1 against one rank with the same masks: the same
    loss and parameter bounds;
  - the ring against JAX's ``ring_causal_attention``: outputs and
    gradients at atol 1e-5 / 1e-4 (the JAX ring tests'), and with dropout
    against the port's one-rank attention on the whole sequence (the same
    masks) at atol 1e-5;
  - the vocab-parallel loss against the dense one: nll and gradient at
    rtol 1e-6 atol 1e-6;
  - checkpoints: the JAX tp save's shard indices, restored bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu_torch.ops.attention import xla_attention
from building_llm_from_scratch_tpu_torch.ops.philox import attention_keep_mask
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    export_params,
    flatten_tree,
    params_from_jax,
)
from test_torch_distributed import LOSS_TOL, PARAM_TOL, SCHED, _cfg_json, spawn
from torch_port_helpers import bits, jax_params, small_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 32
N_STEPS = 3


def _model_files(tmp_path, name, kind, seed, rows=4, **cfg_kw):
    """(jcfg, tcfg, np params, export path, batches path) of one model."""
    ctx = cfg_kw.pop("context_length", T)
    jcfg, tcfg = small_configs(kind, context_length=ctx, **cfg_kw)
    _, np_params = jax_params(jcfg, seed=seed)
    export = str(tmp_path / f"{name}.npz")
    export_params(export, params_from_jax(np_params, tcfg, "cpu"))
    x = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                             (N_STEPS, rows, ctx + 1))
    bpath = str(tmp_path / f"{name}-batches.npz")
    np.savez(bpath, inputs=x[..., :-1].astype(np.int64),
             targets=x[..., 1:].astype(np.int64))
    return jcfg, tcfg, np_params, export, bpath


def _steps_part(name, files, runs, **kw):
    jcfg, tcfg, _, export, bpath = files
    return dict(name=name, scenario="steps", cfg=_cfg_json(tcfg), params=export,
                batches=bpath, sched=list(SCHED), seed=0, steps=N_STEPS,
                runs=runs, **kw)


def _jax_job(label, files, mode, n_dev, **kw):
    jcfg, _, _, export, bpath = files
    import dataclasses

    return dict(kind="steps", label=label, cfg=dataclasses.asdict(jcfg),
                params=export, batches=bpath, sched=list(SCHED), steps=N_STEPS,
                mode=mode, n_dev=n_dev, **kw)


def _jax_refs(tmp_path, jobs) -> dict:
    spec = tmp_path / "jax-refs.json"
    out = tmp_path / "jax-refs.npz"
    spec.write_text(json.dumps({"jobs": jobs}))
    res = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_jax_refs.py"),
                          str(spec), str(out)], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-4000:]
    data = np.load(out)
    return {k: data[k] for k in data.files}


def _ref(refs, label):
    p = f"{label}/"
    return {k[len(p):]: v for k, v in refs.items() if k.startswith(p)}


def _losses(res, label):
    return [m["loss"] for m in res[label]["metrics"]]


def _rel_l2(got: dict, want: dict) -> float:
    diff = sum(float(np.square(got[f"trainable/{k}"].astype(np.float64) - v).sum())
               for k, v in want.items())
    norm = sum(float(np.square(v.astype(np.float64)).sum()) for v in want.values())
    return (diff / norm) ** 0.5


def _params_of(ref):
    return {k[len("trainable/"):]: v for k, v in ref.items() if k.startswith("trainable/")}


def _assert_matches(r, label, ref, loss_tol=LOSS_TOL):
    np.testing.assert_allclose(_losses(r, label), ref["losses"], **loss_tol,
                               err_msg=label)
    want = _params_of(ref)
    assert _rel_l2(r[label]["whole"], want) <= 1e-5, (label, _rel_l2(r[label]["whole"], want))
    for k, v in want.items():
        np.testing.assert_allclose(r[label]["whole"][f"trainable/{k}"], v, **PARAM_TOL,
                                   err_msg=f"{label} {k}")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-rank group's results and the JAX references for them."""
    tmp = tmp_path_factory.mktemp("tp2")
    gpt2 = _model_files(tmp, "gpt2", "gpt2", 3, vocab_size=511)
    gpt2_drop = _model_files(tmp, "gpt2-drop", "gpt2", 4, rows=2, drop_rate=0.1,
                             context_length=256, vocab_size=511, n_heads=2,
                             n_kv_groups=2)
    llama = _model_files(tmp, "llama", "llama", 5)
    deep = _model_files(tmp, "deep", "llama", 8, n_layers=4)
    rng = np.random.default_rng(9)
    xent = str(tmp / "xent.npz")
    np.savez(xent, logits=rng.normal(0, 3, (24, 64)).astype(np.float32),
             targets=rng.integers(0, 64, 24), w=rng.random(24).astype(np.float32))
    save = tmp / "ckpt"
    save.mkdir()
    parts = [
        _steps_part("gpt2", gpt2, [["tp", "tp", None, {"tp": 2}]]),
        _steps_part("llama", llama, [["tp", "tp", None, {"tp": 2}],
                                     ["b4", "tp", None, {"tp": 2, "xent_kernel": True}],
                                     ["noreduce", "tp", None,
                                      {"tp": 2, "skip_reduce": True}],
                                     ["localhealth", "tp", None,
                                      {"tp": 2, "no_health_reduce": True, "steps": 1}]],
                    save=str(save)),
        _steps_part("drop", gpt2_drop, [["tp", "tp", None, {"tp": 2}],
                                        ["one", "control", None, {"all_rows": True}]]),
        dict(name="xent", scenario="xent", xent=xent),
        _steps_part("fsdp", deep, [["fsdp", "fsdp", None, {"census": True}]]),
        # bf16 sums of two ranks do not depend on their order
        _steps_part("sp", gpt2, [["hybrid", "fsdp", "bf16_hybrid", {"sp": 2}]]),
    ]
    res = spawn(tmp, dict(scenario="parts", parts=parts), world=2, timeout=240)
    refs = _jax_refs(tmp, [_jax_job("gpt2", gpt2, "tp", 2, tp=2),
                           _jax_job("deep", deep, "fsdp", 2),
                           _jax_job("hybrid", gpt2, "fsdp", 2, sp=2, policy="bf16_hybrid",
                                    explicit=True),
                           _jax_job("llama", llama, "tp", 2, tp=2),
                           {**_jax_job("ckpt", llama, "tp", 2, tp=2), "kind": "save",
                            "out": str(tmp / "jax-ck")}])
    return dict(res=res, refs=refs, tmp=tmp, files=dict(gpt2=gpt2, llama=llama),
                save=save, xent=xent)


@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_tp_matches_the_jax_gspmd_step(two_ranks, model):
    """tp at 2 on GPT-2 (V = 511: tok_emb and head stay whole) and LLaMA
    (V = 512: both split over the vocabulary, the vocab-parallel loss)
    against the JAX GSPMD step on a (1, 1, 2) mesh: losses and parameters
    at the module's bounds; both ranks report the same losses; the
    forward's all-reduces ran over the model axis."""
    r0, r1 = two_ranks["res"]
    ref = _ref(two_ranks["refs"], model)
    _assert_matches(r0[model], "tp", ref)
    assert _losses(r0[model], "tp") == _losses(r1[model], "tp")
    c = r0[model]["tp"]["counters"]
    assert c["all_reduce@model/fp32"]["calls"] > 0, c
    if model == "llama":
        # the control: without the row-parallel all-reduce the bound fails
        assert _rel_l2(r0["llama"]["noreduce"]["whole"], _params_of(ref)) > 1e-5


def test_tp_dropout_draws_the_one_rank_masks(two_ranks):
    """GPT-2 with dropout 0.1 at T 256 (B1's twin, heads keyed globally;
    residual and embedding masks on the replicated activations) at tp 2
    against one rank on the same batches: the same losses and parameters
    within the module's bounds, so both drew the same masks."""
    r0 = two_ranks["res"][0]["drop"]
    np.testing.assert_allclose(_losses(r0, "tp"), _losses(r0, "one"), **LOSS_TOL)
    assert _rel_l2(r0["tp"]["whole"], r0["one"]["rank_params"]) <= 1e-5


def test_tp_b4_opt_in_gathers_the_head(two_ranks):
    """With B4 asked for (``BLLM_XENT_PALLAS=1``) the LLaMA run's chunked
    loss takes the head gathered over the model axis (on the CPU the
    chunked forward is B4's twin): the JAX GSPMD step's losses and
    parameters within the module's bounds, and the run gathers over the
    model axis where the vocab-parallel run does not."""
    r = two_ranks["res"][0]["llama"]
    _assert_matches(r, "b4", _ref(two_ranks["refs"], "llama"))
    gathers = {run: sum(c["calls"] for k, c in r[run]["counters"].items()
                        if k.startswith("all_gather") and "model" in k)
               for run in ("b4", "tp")}
    assert gathers["b4"] >= N_STEPS and gathers["tp"] == 0, r["b4"]["counters"]


def test_b4_refusal_names_the_reason(monkeypatch):
    """``kernel_refusal``: None on one card at a shape B4 takes; with two
    cards visible (NCCL's tp) or a shape it does not take, the reason."""
    from building_llm_from_scratch_tpu_torch.ops import softmax_xent as sx

    x2 = torch.zeros(256, 128)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sx.kernel_refusal(x2, 512) is None
    assert "does not take (N, D, V) = (256, 100, 512)" in sx.kernel_refusal(
        torch.zeros(256, 100), 512)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert "one device only (2 are visible)" in sx.kernel_refusal(x2, 512)


def test_vocab_parallel_loss_matches_the_dense_loss(two_ranks):
    """Each rank's half of the vocabulary: the nll and its gradient equal
    the dense log-softmax's on the whole logits."""
    d = np.load(two_ranks["xent"])
    logits = torch.from_numpy(d["logits"]).requires_grad_()
    nll = -torch.log_softmax(logits, -1).gather(
        1, torch.from_numpy(d["targets"])[:, None])[:, 0]
    (nll * torch.from_numpy(d["w"])).sum().backward()
    for r, res in enumerate(two_ranks["res"]):
        x = res["xent"]
        np.testing.assert_allclose(x["nll"], nll.detach().numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(x["grad"], logits.grad.numpy()[:, r * 32:(r + 1) * 32],
                                   rtol=1e-6, atol=1e-6)


def test_tp_checkpoint_has_the_jax_layout_and_reads_back(two_ranks):
    """The LLaMA tp state saved by the two ranks: the JAX tp save's leaves,
    shapes, dtypes and shard indices (tok_emb, head and the column / row
    projections in two shards); one port process restores it and holds the
    whole parameters the ranks gathered, bit for bit."""
    from test_torch_distributed import _manifest

    port_ck = str(two_ranks["save"] / "tp")
    jax_ck = two_ranks["tmp"] / "jax-ck"
    pm, jm = _manifest(port_ck), _manifest(str(jax_ck))
    assert list(pm) == list(jm)
    for path, leaf in jm.items():
        for key in ("shape", "dtype"):
            assert pm[path][key] == leaf[key], (path, key)
        assert [sh["index"] for sh in pm[path]["shards"]] == \
            [sh["index"] for sh in leaf["shards"]], path
    assert len(pm["trainable/head/weight"]["shards"]) == 2
    assert len(pm["trainable/blocks/attn/wo"]["shards"]) == 2
    _, tcfg, np_params, _, _ = two_ranks["files"]["llama"]
    model = params_from_jax(np_params, tcfg, "cpu")
    one = tts.init_train_state(model, topt.AdamW(topt.warmup_cosine_schedule(*SCHED)))
    tts.restore_train_state(one, port_ck)
    whole = two_ranks["res"][0]["llama"]["tp"]["whole"]
    for k, v in one.full.items():
        np.testing.assert_array_equal(bits(v), bits(whole[f"trainable/{k}"]), err_msg=k)
    assert one.step == N_STEPS


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four-rank group's results and the JAX references for them."""
    tmp = tmp_path_factory.mktemp("tp4")
    llama = _model_files(tmp, "llama", "llama", 6)
    gpt2 = _model_files(tmp, "gpt2", "gpt2", 7)
    rng = np.random.default_rng(11)
    qkv = {}
    for name, (B, Tq) in {"sp4": (2, 84), "sp2": (4, 250), "drop": (4, 256)}.items():
        path = str(tmp / f"{name}.npz")
        np.savez(path, q=rng.normal(size=(B, Tq, 4, 16)).astype(np.float32),
                 k=rng.normal(size=(B, Tq, 2, 16)).astype(np.float32),
                 v=rng.normal(size=(B, Tq, 2, 16)).astype(np.float32),
                 do=rng.normal(size=(B, Tq, 4, 16)).astype(np.float32))
        qkv[name] = path
    parts = [
        _steps_part("tp_fsdp", llama, [["tp_fsdp", "tp_fsdp", None, {"tp": 2}]]),
        _steps_part("sp", gpt2, [["fsdp", "fsdp", None, {"sp": 2}]]),
        dict(name="ring4", scenario="ring", qkv=qkv["sp4"], sp=4),
        dict(name="ring2", scenario="ring", qkv=qkv["sp2"], sp=2),
        dict(name="ringdrop", scenario="ring", qkv=qkv["drop"], sp=2, rate=0.1, seed=77),
    ]
    res = spawn(tmp, dict(scenario="parts", parts=parts), world=4, timeout=300)
    refs = _jax_refs(tmp, [
        _jax_job("tp_fsdp", llama, "tp_fsdp", 4, tp=2),
        _jax_job("fsdp", gpt2, "fsdp", 4, sp=2),
        dict(kind="ring", label="ring4", qkv=qkv["sp4"], sp=4),
        dict(kind="ring", label="ring2", qkv=qkv["sp2"], sp=2)])
    return dict(res=res, refs=refs, qkv=qkv)


def test_tp_fsdp_matches_the_jax_gspmd_step(four_ranks):
    """tp_fsdp on a (2, 1, 2) mesh (LLaMA, vocab-parallel) against the JAX
    GSPMD step on the same mesh shape; every rank reports the same losses
    and, between steps, holds no working copy of its fsdp-sharded
    leaves."""
    res = four_ranks["res"]
    _assert_matches(res[0]["tp_fsdp"], "tp_fsdp", _ref(four_ranks["refs"], "tp_fsdp"))
    for r in res:
        assert _losses(r["tp_fsdp"], "tp_fsdp") == _losses(res[0]["tp_fsdp"], "tp_fsdp")
        run = r["tp_fsdp"]["tp_fsdp"]
        assert run["sharded"] and run["freed"] == run["sharded"]


def test_sp_fsdp_matches_the_jax_gspmd_sp_step(four_ranks):
    """GPT-2 fsdp on a (2, 2, 1) mesh, T split over seq (the ring, global
    positions) against the JAX GSPMD sp step on the same mesh shape; the
    k/v blocks went round the seq groups."""
    res = four_ranks["res"]
    _assert_matches(res[0]["sp"], "fsdp", _ref(four_ranks["refs"], "fsdp"))
    assert res[0]["sp"]["fsdp"]["counters"]["send@seq/fp32"]["calls"] > 0


def test_sp_bf16_hybrid_matches_the_jax_explicit_sp_step(two_ranks):
    """bf16_hybrid at sp 2 (a (1, 2, 1) mesh) against the JAX explicit sp
    step: the losses, and each leaf within 1e-3 of its update; every
    gradient reduce moves bf16."""
    r = two_ranks["res"][0]["sp"]
    ref = _ref(two_ranks["refs"], "hybrid")
    np.testing.assert_allclose(_losses(r, "hybrid"), ref["losses"], **LOSS_TOL)
    _, _, np_params, _, _ = two_ranks["files"]["gpt2"]
    init = {k: np.asarray(v, np.float32) for k, v in flatten_tree(np_params).items()}
    for k, v in _params_of(ref).items():
        got = r["hybrid"]["whole"][f"trainable/{k}"]
        assert np.linalg.norm(got - v) <= 1e-3 * np.linalg.norm(v - init[k]), k
    c = r["hybrid"]["counters"]
    assert c["all_reduce/bf16"]["calls"] == N_STEPS * len(init), c
    assert "reduce_scatter/fp32" not in c


@pytest.mark.parametrize("name", ["ring4", "ring2"])
def test_ring_matches_the_jax_ring(four_ranks, name):
    """The ring's output and gradients against JAX's ring_causal_attention
    at sp 4 (T 84: 21 a rank) and sp 2 (T 250: 125, odd), each rank's
    block of the rows its data index holds."""
    want = _ref(four_ranks["refs"], name)
    for r in four_ranks["res"]:
        x = r[name]
        (d, nd), (c0, c1) = x["rows"], x["cols"]
        np.testing.assert_allclose(x["out"], want["out"][d::nd, c0:c1], atol=1e-5, rtol=1e-5)
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(x[g], want[g][d::nd, c0:c1], atol=1e-4, rtol=1e-4,
                                       err_msg=f"{name} {g}")


def test_ring_dropout_draws_the_one_rank_masks(four_ranks):
    """sp 2 with attention dropout 0.1: each rank's block equals the
    port's one-rank attention over its data index's rows and the whole
    sequence with the same seed (so the same mask, keyed on global
    positions), and a second forward repeats it bit for bit."""
    d = np.load(four_ranks["qkv"]["drop"])
    for r in four_ranks["res"]:
        x = r["ringdrop"]
        (a, na), (c0, c1) = x["rows"], x["cols"]
        # one rank on this data index's rows over the whole sequence
        q, k, v = (torch.from_numpy(d[n][a::na]) for n in ("q", "k", "v"))
        want = xla_attention(q, k, v, dropout_rate=0.1, seed=77, deterministic=False)
        np.testing.assert_allclose(x["out"], want[:, c0:c1].numpy(), atol=1e-5, rtol=1e-5)
        assert not np.allclose(x["out"], xla_attention(q, k, v)[:, c0:c1].numpy(),
                               atol=1e-3)
        assert x["repeat_equal"]


def test_ring_dropout_masks_are_blocks_of_the_whole_mask():
    """The keep mask of a (query block, key block, head range) at global
    offsets is that block of the whole (B, H, T, T) mask, at even and odd
    offsets; the kept share is 1 - rate."""
    whole = attention_keep_mask(5, 2, 4, 30, 30, 0.25)
    for q0, k0, h0, n in ((0, 0, 0, 10), (10, 0, 2, 10), (15, 5, 1, 15), (21, 3, 0, 9)):
        got = attention_keep_mask(5, 2, 4 - h0, n, n, 0.25, q0=q0, k0=k0, h0=h0)
        assert torch.equal(got, whole[:, h0:, q0:q0 + n, k0:k0 + n]), (q0, k0, h0)
    assert abs(float(whole.float().mean()) - 0.75) < 0.02


def test_fsdp_gathers_layer_by_layer(two_ranks):
    """fsdp at world 2 on a 4-layer LLaMA against the JAX GSPMD fsdp step
    (the module's bounds): at every block boundary of every step, forward
    and backward, at most two layers' gathered weights are held, every
    layer was gathered, once forward and once backward (the backward in
    reverse order), and between steps no working copy remains."""
    r = two_ranks["res"][0]["fsdp"]
    _assert_matches(r, "fsdp", _ref(two_ranks["refs"], "deep"))
    census = r["fsdp"]["layers_held"]
    assert len(census) == N_STEPS
    for held in census:
        assert [layer for layer, _ in held] == [0, 1, 2, 3, 3, 2, 1, 0], held
        assert all(layer in slots and len(slots) <= 2 for layer, slots in held), held
    assert r["fsdp"]["freed"] == r["fsdp"]["sharded"]


def test_cli_tp_matches_the_jax_cli_and_one_rank(tmp_path):
    """``main.run --run_type multi_chip`` on two ranks under torchrun's
    environment with ``--shard_mode tp --tp 2`` (the data rank's rows: the
    whole batch on both ranks) against the JAX CLI with the same flags
    (``--shard_mode tp --tp 2`` over the test mesh, in the references'
    process) and against the port's single_chip CLI: the evaluations
    within the module's loss bounds, the final export (gathered over the
    model axis) within its parameter bounds, the same tokens seen and
    steps, the warm-up sample on rank 0 only, rank 0's telemetry (with
    ``--metrics_jsonl --log_every 1 --stall_timeout``: a metrics and a
    health row a step); launched again from the tp run's sharded final
    checkpoint, a second epoch resumes at its step."""
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        load_exported_params,
    )

    from test_torch_distributed import _cli_flags

    # three global batches of 8 windows, from a JAX init export
    common = ["--batch_size", "8", "--eval_freq", "3", "--print_sample_iter", "1000"]
    flags = _cli_flags(tmp_path, 3, common + ["--device", "cpu"])
    multi = ["--run_type", "multi_chip"]
    jflags = _cli_flags(tmp_path, 3, common) + multi + [
        "--shard_mode", "tp", "--tp", "2", "--save_ckpt_freq", "1000",
        "--output_dir", str(tmp_path / "jax-tp")]
    jx = _jax_refs(tmp_path, [dict(kind="cli", label="jax", flags=jflags,
                                   export=str(tmp_path / "jax-tp" / "model_pg_final.npz"))])
    jx = _ref(jx, "jax")
    # a resume restores the whole state: no --init_params_from beside it
    i = flags.index("--init_params_from")
    fresh = flags[:i] + flags[i + 2:]
    tp = flags + multi + ["--shard_mode", "tp", "--tp", "2",
                          "--output_dir", str(tmp_path / "tp"),
                          "--metrics_jsonl", str(tmp_path / "tp.jsonl"),
                          "--log_every", "1", "--stall_timeout", "120"]
    runs = [["tp", tp],
            ["resumed", fresh + multi + ["--shard_mode", "tp", "--tp", "2",
                                         "--resume_from", str(tmp_path / "tp" / "model_pg_final"),
                                         "--output_dir", str(tmp_path / "tp-resumed")]]]
    res = spawn(tmp_path, dict(scenario="cli", runs=runs), world=2, timeout=240)
    one = tmain.run(flags + ["--output_dir", str(tmp_path / "one")])
    want = flatten_tree(one.model.flat_params())
    r0, r1 = res[0]["tp"], res[1]["tp"]
    assert r0["global_step"] == r1["global_step"] == one.global_step > 0
    np.testing.assert_allclose(r0["train_losses"], one.train_losses, **LOSS_TOL)
    np.testing.assert_allclose(r0["val_losses"], one.val_losses, **LOSS_TOL)
    assert r0["losses"] == r1["losses"]
    assert r0["tokens_seen"] == one.tokens_seen
    assert len(r0["samples"]) == 1 and r1["samples"] == []
    got = flatten_tree(load_exported_params(
        str(tmp_path / "tp" / "model_pg_final.npz"), one.cfg, "cpu").flat_params())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **PARAM_TOL, err_msg=k)
    # the JAX CLI under the same tp flags
    assert r0["global_step"] == int(jx["global_step"])
    np.testing.assert_allclose(r0["train_losses"], jx["train_losses"], **LOSS_TOL)
    np.testing.assert_allclose(r0["val_losses"], jx["val_losses"], **LOSS_TOL)
    assert r0["tokens_seen"] == int(jx["tokens_seen"])
    jparams = {k[len("params/"):]: v for k, v in jx.items() if k.startswith("params/")}
    assert set(jparams) == set(got)
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k].numpy(), v, **PARAM_TOL, err_msg=f"jax {k}")
    for r in res:
        assert r["resumed"]["restored"]["step"] == one.global_step
        assert r["resumed"]["global_step"] == 2 * one.global_step
        assert r["resumed"]["losses"] and all(np.isfinite(r["resumed"]["losses"]))
    # the training telemetry of the tp run: rank 0's file, a metrics and a
    # health row a step over the whole model's groups, no stall
    rows = [json.loads(line) for line in (tmp_path / "tp.jsonl").read_text().splitlines()]
    assert rows[0]["type"] == "header" and rows[0]["mesh_shape"]["model"] == 2
    health = [r for r in rows if r["type"] == "health"]
    assert [r["step"] for r in rows if r["type"] == "metrics"] == \
        [r["step"] for r in health] == list(range(1, one.global_step + 1))
    assert len(health[0]["groups"]) == one.cfg.n_layers + 3
    assert all(np.isfinite(r["grad_norm"]).all() for r in health)
    assert not [r for r in rows if r.get("event") == "stall"]


#: the health bundle's per-group arrays against the JAX step's, first step
HEALTH_ARRAYS = ("grad_norm", "param_norm", "update_norm", "update_ratio")
HEALTH_RTOL = 1e-5


def _health_err(got: dict, ref: dict) -> float:
    return max(float(np.max(np.abs(got[k].astype(np.float64) - ref[f"health/{k}"])
                            / np.abs(ref[f"health/{k}"]).clip(min=1e-30)))
               for k in HEALTH_ARRAYS)


@pytest.mark.parametrize("group,part,label,ref", [
    ("two_ranks", "gpt2", "tp", "gpt2"), ("two_ranks", "llama", "tp", "llama"),
    ("two_ranks", "fsdp", "fsdp", "deep"), ("four_ranks", "tp_fsdp", "tp_fsdp", "tp_fsdp"),
    ("four_ranks", "sp", "fsdp", "fsdp")])
def test_health_matches_the_jax_bundle(request, group, part, label, ref):
    """The first step's per-layer-group health bundle under tp 2 (GPT-2 with
    the replicated vocabulary, LLaMA vocab-parallel), fsdp 2 (4 layers),
    tp_fsdp on (2, 1, 2) and fsdp x sp on (2, 2, 1) against the JAX GSPMD
    step's on the same mesh shape: every rank holds the whole vector (each
    leaf's slices summed over the axes it is split on, replicated leaves
    counted once) within 1e-5 relative. Control (LLaMA tp): each rank's
    bundle of its own slices, unreduced, fails it."""
    res = request.getfixturevalue(group)
    want = _ref(res["refs"], ref)
    for r in res["res"]:
        h = r[part][label]["metrics"][0]["health"]
        assert h["grad_norm"].shape == want["health/grad_norm"].shape
        assert _health_err(h, want) <= HEALTH_RTOL, (part, _health_err(h, want))
        assert int(h["first_nonfinite"]) == -1
    if part == "llama":
        local = res["res"][0]["llama"]["localhealth"]["metrics"][0]["health"]
        assert _health_err(local, want) > HEALTH_RTOL
