"""The port's pipeline parallelism (``--shard_mode pp``, ``--pp``,
``--pp_micro``) in real gloo groups on the CPU (``tests/torch_dist_worker.py``),
against the JAX package's ``make_pp_train_step`` on a CPU mesh of the same
shape (``make_pp_mesh``).

One two-rank group (pp 2 on a (1, 2, 1) mesh: LLaMA-like and GPT-2-like
models, LoRA, the eval loss, the remat modes, dropout against one process,
the two controls, a checkpoint and a resume) and one four-rank group (pp 2
x data 2 on (2, 2, 1), pp 2 x tp 2 on (1, 2, 2), the JAX pp save restored,
and the CLI on (2, 2, 1)) serve every scenario. The JAX references run in
one process of their own (``tests/torch_jax_refs.py``, four CPU devices),
started before the two-rank group and read before the four-rank one.

Tolerances (``test_torch_distributed.py``'s):
  - against the JAX pp step in bf16 (the LLaMA-like model): the
    single-device bf16 bounds of ``test_torch_training.py``, each step's
    loss within 1e-3 relative and each leaf's total update within 0.15 of
    the JAX update's norm; the replicated leaves' gradients summed without
    the stage axis fail them;
  - the first step's health bundle against the JAX pp step's: 1e-5
    relative per group; each rank's unreduced bundle fails it;
  - against the JAX pp step (fp32): per-step losses rtol 2e-4 atol 2e-5;
    final parameters within 1e-5 relative L2 (all leaves as one vector) and
    each leaf at rtol 2e-3 atol 2e-5; each control fails the relative-L2
    bound: a hop whose activation is zeroed (left unsent), and the
    replicated leaves' gradients summed over the data line alone (the
    stage all-reduce skipped);
  - GPT-2-like with dropout 0.1 at pp 2 against one process drawing the
    same folded masks (``dropout_stages``): the same bounds;
  - remat modes and the resume: bit for bit;
  - checkpoints: the JAX pp save's shard indices, restored bit for bit by
    either package.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu_torch.models.lora import save_adapter
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    export_params,
    flatten_tree,
    lora_from_jax,
    params_from_jax,
)
from test_torch_distributed import LOSS_TOL, PARAM_TOL, SCHED, _cfg_json, spawn
from torch_port_helpers import bits, jax_params, make_jax_lora, small_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 32
N_STEPS = 3
ROWS = 8
MICRO = 4
PP2 = {"pp": 2, "micro": MICRO}


def _model_files(tmp, name, kind, seed, **cfg_kw):
    """(jcfg, tcfg, np params, export path, batches path) of one model."""
    jcfg, tcfg = small_configs(kind, context_length=T, n_layers=4, **cfg_kw)
    _, np_params = jax_params(jcfg, seed=seed)
    export = str(tmp / f"{name}.npz")
    export_params(export, params_from_jax(np_params, tcfg, "cpu"))
    x = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (N_STEPS, ROWS, T + 1))
    bpath = str(tmp / f"{name}-batches.npz")
    np.savez(bpath, inputs=x[..., :-1].astype(np.int64),
             targets=x[..., 1:].astype(np.int64))
    return jcfg, tcfg, np_params, export, bpath


def _part(name, files, runs, **kw):
    _, tcfg, _, export, bpath = files
    return dict(name=name, scenario="steps", cfg=_cfg_json(tcfg), params=export,
                batches=bpath, sched=list(SCHED), seed=0, steps=N_STEPS,
                runs=runs, **kw)


def _jax_job(label, files, n_dev, **kw):
    import dataclasses

    jcfg, _, _, export, bpath = files
    return dict(kind="pp", label=label, cfg=dataclasses.asdict(jcfg), params=export,
                batches=bpath, sched=list(SCHED), steps=N_STEPS, pp=2,
                micro=MICRO, n_dev=n_dev, **kw)


def _start_refs(tmp, jobs):
    """The JAX references' process (four CPU devices), started now."""
    spec, out = tmp / "jax-refs.json", tmp / "jax-refs.npz"
    spec.write_text(json.dumps({"jobs": jobs}))
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_jax_refs.py"),
                             str(spec), str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def _read_refs(proc, out) -> dict:
    try:
        log = proc.communicate(timeout=240)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail("the JAX references did not finish in 240 s")
    assert proc.returncode == 0, log[-4000:]
    data = np.load(out)
    return {k: data[k] for k in data.files}


def _ref(refs, label):
    p = f"{label}/"
    return {k[len(p):]: v for k, v in refs.items() if k.startswith(p)}


def _losses(part, label):
    return [m["loss"] for m in part[label]["metrics"]]


def _params_of(ref):
    return {k[len("trainable/"):]: v for k, v in ref.items() if k.startswith("trainable/")}


def _rel_l2(got: dict, want: dict) -> float:
    diff = sum(float(np.square(got[f"trainable/{k}"].astype(np.float64) - v).sum())
               for k, v in want.items())
    norm = sum(float(np.square(v.astype(np.float64)).sum()) for v in want.values())
    return (diff / norm) ** 0.5


def _assert_matches(part, label, ref):
    np.testing.assert_allclose(_losses(part, label), ref["losses"], **LOSS_TOL,
                               err_msg=label)
    want = _params_of(ref)
    got = part[label]["whole"]
    assert set(want) <= {k[len("trainable/"):] for k in got if k.startswith("trainable/")}
    assert _rel_l2(got, want) <= 1e-5, (label, _rel_l2(got, want))
    for k, v in want.items():
        np.testing.assert_allclose(got[f"trainable/{k}"], v, **PARAM_TOL,
                                   err_msg=f"{label} {k}")


def _cli_flags(tmp):
    from test_torch_distributed import _cli_flags

    return _cli_flags(tmp, 3, ["--batch_size", "8", "--eval_freq", "3",
                               "--print_sample_iter", "1000"])


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups' results and the JAX references for them."""
    tmp = tmp_path_factory.mktemp("pp")
    llama = _model_files(tmp, "llama", "llama", 5)
    llama16 = _model_files(tmp, "llama16", "llama", 5, dtype="bf16")
    gpt2 = _model_files(tmp, "gpt2", "gpt2", 3, vocab_size=511)
    drop = _model_files(tmp, "drop", "gpt2", 4, vocab_size=511, drop_rate=0.1)
    jcfg, tcfg, np_params = llama[:3]
    jlora = make_jax_lora(jcfg, np_params, seed=21, rank=4)
    adapter = str(tmp / "adapter.npz")
    save_adapter(adapter, lora_from_jax(jlora, tcfg, "cpu"), rank=4, alpha=8.0, cfg=tcfg)
    lspec = dict(path=adapter, rank=4, alpha=8.0)
    for d in ("port-ck", "resume-ck"):
        (tmp / d).mkdir()
    # the CLI: debug LLaMA fp32 from a JAX export, 3 batches of 8
    cli_dir = tmp / "cli"
    cli_dir.mkdir()
    flags = _cli_flags(cli_dir) + ["--run_type", "multi_chip", "--shard_mode", "pp",
                                   "--pp", "2", "--pp_micro", str(MICRO),
                                   "--save_ckpt_freq", "1000"]
    proc, out = _start_refs(tmp, [
        _jax_job("llama", llama, 2, save=str(tmp / "jax-ck")),
        _jax_job("llama16", llama16, 2),
        _jax_job("gpt2", gpt2, 2),
        _jax_job("lora", llama, 2, lora=adapter),
        _jax_job("data", llama, 4),
        _jax_job("tp", llama, 4, tp=2),
        dict(kind="cli", label="cli", flags=flags + ["--output_dir", str(cli_dir / "jax")],
             export=str(cli_dir / "jax" / "model_pg_final.npz"))])
    pp, det = dict(PP2), dict(PP2, deterministic=True)
    two = spawn(tmp, dict(scenario="parts", parts=[
        _part("llama", llama, [["pp", "pp", None, pp],
                               ["nohop", "pp", None, dict(pp, drop_hop=True)],
                               ["noreduce", "pp", None, dict(pp, skip_stage_reduce=True)],
                               ["localhealth", "pp", None,
                                dict(pp, no_health_reduce=True, steps=1)]],
              eval=True, save=str(tmp / "port-ck")),
        _part("llama16", llama16, [["pp", "pp", None, pp],
                                   ["noreduce", "pp", None,
                                    dict(pp, skip_stage_reduce=True)]]),
        _part("gpt2", gpt2, [["pp", "pp", None, pp]]),
        _part("lora", llama, [["pp", "pp", None, pp]], lora=lspec),
        _part("drop", drop, [["pp", "pp", None, pp],
                             ["one", "pp_one", None, dict(pp, dropout_stages=2)],
                             ["unsplit", "pp_one", None, pp]]),
        _part("remat", llama, [["selective", "pp", None, det],
                               ["save_all", "pp", None, dict(det, save_all=True)]]),
        dict(_part("full", llama, [["full", "pp", None, det]]),
             cfg=dict(_cfg_json(tcfg), use_actv_ckpt=True)),
        _part("resume", llama, [["unbroken", "pp", None, det],
                                ["first", "pp", None, dict(det, steps=2,
                                                           save=str(tmp / "resume-ck"))],
                                ["resumed", "pp", None,
                                 dict(det, resume=str(tmp / "resume-ck" / "first"))]]),
    ]), world=2, timeout=240)
    refs = _read_refs(proc, out)
    four = spawn(tmp, dict(scenario="parts", parts=[
        _part("data", llama, [["pp", "pp", None, pp]]),
        _part("tp", llama, [["pp", "pp", None, dict(pp, tp=2)]]),
        _part("load", llama, [["tp", "pp", None, dict(pp, tp=2)]],
              load=str(tmp / "jax-ck")),
        dict(name="cli", scenario="cli", runs=[
            ["pp", flags + ["--device", "cpu", "--output_dir", str(cli_dir / "port"),
                            "--metrics_jsonl", str(cli_dir / "port.jsonl"),
                            "--log_every", "1", "--stall_timeout", "120"]]]),
    ]), world=4, timeout=240)
    return dict(two=two, four=four, refs=refs, tmp=tmp, llama=llama, cli_dir=cli_dir,
                llama16=llama16)


@pytest.mark.parametrize("model", ["llama", "gpt2"])
def test_pp_matches_the_jax_pp_step(groups, model):
    """pp 2 with 4 microbatches on a LLaMA-like (RMSNorm, RoPE, GQA,
    SwiGLU) and a GPT-2-like (biases, pos_emb, LayerNorm, V 511) model of 4
    layers against the JAX pp step on 2 devices: losses and parameters at
    the module's bounds; both ranks report the same losses; the
    activations and their gradients hopped over the stage axis (4
    microbatches x 3 steps each way)."""
    r0, r1 = (r[model] for r in groups["two"])
    _assert_matches(r0, "pp", _ref(groups["refs"], model))
    assert _losses(r0, "pp") == _losses(r1, "pp")
    # stage 0 sends each microbatch's activation (the LLaMA part's
    # evaluation adds one batch), stage 1 its gradient
    evals = MICRO if model == "llama" else 0
    assert r0["pp"]["counters"]["send@stage/fp32"]["calls"] == MICRO * N_STEPS + evals
    assert r1["pp"]["counters"]["send@stage/fp32"]["calls"] == MICRO * N_STEPS


def test_pp_x_data_matches_the_jax_pp_step(groups):
    """pp 2 x data 2 on a (2, 2, 1) mesh (each data column pipelines its
    contiguous row of every microbatch) against the JAX pp step on the same
    mesh shape; the block gradients summed over the data line."""
    res = groups["four"]
    _assert_matches(res[0]["data"], "pp", _ref(groups["refs"], "data"))
    for r in res:
        assert _losses(r["data"], "pp") == _losses(res[0]["data"], "pp")
        assert r["data"]["pp"]["counters"]["all_reduce/fp32"]["calls"] > 0


def test_pp_x_tp_matches_the_jax_pp_step(groups):
    """pp 2 x tp 2 on a (1, 2, 2) mesh under ``_PP_TP_RULES`` (a divisible
    vocabulary, V 512, whose embedding and head stay whole: no
    vocab-parallel loss under pp) against the JAX pp step; Megatron's
    reduces ran over the model axis; each rank holds half its stage's
    column- and row-parallel leaves and the whole head."""
    res = groups["four"]
    _assert_matches(res[0]["tp"], "pp", _ref(groups["refs"], "tp"))
    _, tcfg, np_params, _, _ = groups["llama"]
    whole = flatten_tree(np_params)
    for r in res:
        run = r["tp"]["pp"]
        assert _losses(r["tp"], "pp") == _losses(res[0]["tp"], "pp")
        assert run["counters"]["all_reduce@model/fp32"]["calls"] > 0
        held = run["rank_params"]
        assert held["head/weight"].shape == whole["head/weight"].shape
        assert held["tok_emb/weight"].shape == whole["tok_emb/weight"].shape
        L, D, F = whole["blocks/attn/wq"].shape
        assert held["blocks/attn/wq"].shape == (L // 2, D, F // 2)
        assert held["blocks/mlp/down"].shape[:2] == (L // 2, tcfg.hidden_dim // 2)


def test_pp_lora_matches_the_jax_pp_step(groups):
    """LoRA (rank 4, nonzero B) under pp 2 against the JAX pp step: the
    adapter's leaves at the module's bounds and the frozen base unchanged
    bit for bit (the counterpart of ``test_pp_lora_matches_single_device``)."""
    r = groups["two"][0]["lora"]
    _assert_matches(r, "pp", _ref(groups["refs"], "lora"))
    _, _, np_params, _, _ = groups["llama"]
    for k, v in flatten_tree(np_params).items():
        np.testing.assert_array_equal(bits(r["pp"]["whole"][f"frozen/{k}"]),
                                      bits(np.asarray(v, np.float32)), err_msg=k)


def test_pp_eval_matches_the_jax_pp_eval(groups):
    """The pp eval loss on the first batch after the steps equals the JAX
    ``make_pp_eval_step``'s within the loss bound, on both ranks."""
    want = float(_ref(groups["refs"], "llama")["eval"])
    for r in groups["two"]:
        np.testing.assert_allclose(r["llama"]["pp"]["eval"], want, **LOSS_TOL)


def test_pp_remat_modes_give_equal_gradients(groups):
    """Selective-save remat (the default), full remat (``use_actv_ckpt``)
    and save-all under pp 2: the same losses and parameters bit for bit
    on every rank."""
    for r in groups["two"]:
        base = r["remat"]["selective"]
        for part, label in (("remat", "save_all"), ("full", "full")):
            other = r[part][label]
            assert _losses(r[part], label) == _losses(r["remat"], "selective")
            for k, v in base["whole"].items():
                np.testing.assert_array_equal(bits(other["whole"][k]), bits(v),
                                              err_msg=f"{label} {k}")


def test_pp_dropout_draws_the_one_process_masks(groups):
    """GPT-2-like with dropout 0.1 at pp 2 against one process holding
    every layer with the same folded seeds (``dropout_stages=2``): the
    losses and parameters within the module's bounds; one process folding
    its own single stage (other masks) falls outside them."""
    r = groups["two"][0]["drop"]
    np.testing.assert_allclose(_losses(r, "pp"), _losses(r, "one"), **LOSS_TOL)

    def params(label):
        return {k[len("trainable/"):]: v for k, v in r[label]["whole"].items()
                if k.startswith("trainable/")}
    assert _rel_l2(r["pp"]["whole"], params("one")) <= 1e-5
    assert _rel_l2(r["pp"]["whole"], params("unsplit")) > 1e-5


@pytest.mark.parametrize("control", ["nohop", "noreduce"])
def test_pp_controls_fail_the_bound(groups, control):
    """The controls of the LLaMA-like run: a forward hop whose activation
    is zeroed (left unsent) and the replicated leaves' gradients summed
    without the stage axis each fall outside the relative-L2 bound that
    the real run meets."""
    r = groups["two"][0]["llama"]
    want = _params_of(_ref(groups["refs"], "llama"))
    assert _rel_l2(r["pp"]["whole"], want) <= 1e-5
    assert _rel_l2(r[control]["whole"], want) > 1e-5


def test_pp_checkpoint_has_the_jax_layout(groups):
    """The port's pp save (2 ranks) has the JAX pp save's leaves, shapes,
    dtypes and shard indices: block leaves and their moments in two stage
    shards, everything else whole."""
    from test_torch_distributed import _manifest

    pm = _manifest(str(groups["tmp"] / "port-ck" / "pp"))
    jm = _manifest(str(groups["tmp"] / "jax-ck"))
    assert list(pm) == list(jm)
    for path, leaf in jm.items():
        for key in ("shape", "dtype"):
            assert pm[path][key] == leaf[key], (path, key)
        assert [sh["index"] for sh in pm[path]["shards"]] == \
            [sh["index"] for sh in leaf["shards"]], path
    assert len(pm["trainable/blocks/attn/wq"]["shards"]) == 2
    assert len(pm["opt_state/1/mu/blocks/mlp/down"]["shards"]) == 2
    assert len(pm["trainable/head/weight"]["shards"]) == 1


def test_pp_checkpoints_cross_packages(groups):
    """Four port ranks (pp 2 x tp 2) restore the JAX pp save and hold its
    parameters bit for bit; the JAX ``load_checkpoint`` restores the
    port's pp save and holds the ranks' gathered parameters and moments
    bit for bit."""
    import jax

    from building_llm_from_scratch_tpu.training import checkpoint as jckpt
    from building_llm_from_scratch_tpu.training.optim import (
        build_optimizer,
        warmup_cosine_schedule,
    )
    from building_llm_from_scratch_tpu.training.train_step import init_train_state

    want = _params_of(_ref(groups["refs"], "llama"))
    for r in groups["four"]:
        got = r["load"]["tp"]["whole"]
        for k, v in want.items():
            np.testing.assert_array_equal(bits(got[f"trainable/{k}"]), bits(v), err_msg=k)
    jcfg, _, np_params, _, _ = groups["llama"]
    template = init_train_state(jax.tree_util.tree_map(np.asarray, np_params),
                                build_optimizer(schedule=warmup_cosine_schedule(*SCHED)),
                                jax.random.PRNGKey(0))
    restored = jckpt.load_checkpoint(str(groups["tmp"] / "port-ck" / "pp"), template)
    whole = groups["two"][0]["llama"]["pp"]["whole"]
    flat = flatten_tree(jax.device_get(restored["trainable"]))
    mu = flatten_tree(jax.device_get(restored["opt_state"][1].mu))
    for k, v in flat.items():
        np.testing.assert_array_equal(bits(np.asarray(v)), bits(whole[f"trainable/{k}"]),
                                      err_msg=k)
        np.testing.assert_array_equal(bits(np.asarray(mu[k])), bits(whole[f"mu/{k}"]),
                                      err_msg=f"mu {k}")
    assert int(restored["step"]) == N_STEPS


def test_pp_resume_equals_the_unbroken_run(groups):
    """Two steps, a pp checkpoint, then a fresh state restored from it and
    one more step: the unbroken run's loss and parameters bit for bit."""
    for r in groups["two"]:
        res = r["resume"]
        assert _losses(res, "resumed") == _losses(res, "unbroken")[2:]
        assert _losses(res, "first") == _losses(res, "unbroken")[:2]
        for k, v in res["unbroken"]["whole"].items():
            np.testing.assert_array_equal(bits(res["resumed"]["whole"][k]), bits(v),
                                          err_msg=k)


def test_cli_pp_matches_the_jax_cli(groups):
    """``main.run --run_type multi_chip --shard_mode pp --pp 2 --pp_micro 4
    --device cpu`` on four ranks under torchrun's environment ((2, 2, 1):
    every rank loads the global batch) against the JAX CLI with the same
    flags on four CPU devices: the evaluations within the loss bounds, the
    final export within the parameter bounds, the same tokens seen and
    steps on every rank, the warm-up sample on rank 0 only."""
    from building_llm_from_scratch_tpu_torch.configs import get_config
    from building_llm_from_scratch_tpu_torch.training.checkpoint import (
        load_exported_params,
    )

    jx = _ref(groups["refs"], "cli")
    res = [r["cli"]["pp"] for r in groups["four"]]
    for r in res:
        assert r["global_step"] == int(jx["global_step"]) == 3
        assert r["tokens_seen"] == int(jx["tokens_seen"])
        np.testing.assert_allclose(r["train_losses"], jx["train_losses"], **LOSS_TOL)
        np.testing.assert_allclose(r["val_losses"], jx["val_losses"], **LOSS_TOL)
        assert r["losses"] == res[0]["losses"]
    assert len(res[0]["samples"]) == 1 and all(r["samples"] == [] for r in res[1:])
    cfg = get_config("llama3_2", "1B", dtype="fp32", debug=True)
    got = flatten_tree(load_exported_params(
        str(groups["cli_dir"] / "port" / "model_pg_final.npz"), cfg, "cpu").flat_params())
    jparams = {k[len("params/"):]: v for k, v in jx.items() if k.startswith("params/")}
    assert set(jparams) == set(got)
    for k, v in jparams.items():
        np.testing.assert_allclose(got[k].numpy(), v, **PARAM_TOL, err_msg=k)


def test_pp_cli_writes_the_training_telemetry(groups):
    """The four-rank pp CLI run with ``--metrics_jsonl --log_every 1
    --stall_timeout``: rank 0 alone writes one header (the (2, 2, 1) mesh),
    a metrics row and a health row a step, the health rows naming every
    block of the whole model (each stage's layers assembled over the stage
    axis), finite; no stall fired."""
    rows = [json.loads(line) for line in
            (groups["cli_dir"] / "port.jsonl").read_text().splitlines()]
    assert [r["type"] for r in rows].count("header") == 1
    assert rows[0]["mesh_shape"] == {"data": 2, "stage": 2, "model": 1}
    metrics = [r for r in rows if r["type"] == "metrics"]
    health = [r for r in rows if r["type"] == "health"]
    assert [r["step"] for r in metrics] == [r["step"] for r in health] == [1, 2, 3]
    blocks = [g for g in health[0]["groups"] if g.startswith("block_")]
    assert blocks == [f"block_{i:02d}" for i in range(len(blocks))] and len(blocks) >= 2
    for r in health:
        assert all(np.isfinite(r[k]).all() for k in ("grad_norm", "param_norm",
                                                     "update_norm"))
        assert r["first_nonfinite"] is None
    assert all(r["mfu"] is None and r["steps_in_window"] == 1 for r in metrics)
    assert not [r for r in rows if r.get("event") == "stall"]


# ---------------------------------------------------------------------------
# one process, no group: the mesh, the rules, the seeds, the flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,stages,tp", [(4, 2, 1), (4, 2, 2), (8, 2, 2), (8, 4, 1)])
def test_pp_mesh_and_specs_match_jax(world, stages, tp):
    """``make_pp_mesh`` lays ranks out as the JAX one lays devices
    (stage-major: stage s owns the contiguous ranks [s D T, (s+1) D T));
    ``PipelinePlan.param_spec`` equals the JAX plan's for every leaf of a
    LLaMA-like and a GPT-2-like model and of a LoRA adapter."""
    import jax

    from building_llm_from_scratch_tpu.parallel.pipeline import (
        PipelinePlan as JPlan,
        make_pp_mesh as jmesh,
    )
    from building_llm_from_scratch_tpu_torch.models.lora import adapted_shapes
    from building_llm_from_scratch_tpu_torch.models.transformer import param_shapes
    from building_llm_from_scratch_tpu_torch.parallel.pipeline import (
        PipelinePlan,
        make_pp_mesh,
    )

    jm = jmesh(stages, jax.devices()[:world], tp=tp)
    mesh = make_pp_mesh(stages, tp=tp, world_size=world)
    assert dict(jm.shape) == mesh.shape
    for (d, s, m), dev in np.ndenumerate(jm.devices):
        assert mesh.rank_of(d, s, m) == dev.id
        assert mesh.coords(dev.id) == {"data": d, "stage": s, "model": m}
    jplan = JPlan(jm, n_micro=4)
    for r in range(world):
        plan = PipelinePlan(mesh=mesh, n_micro=4, rank=r)
        assert plan.stage_rank == r // (world // stages)
    for kind in ("llama", "gpt2"):
        _, tcfg = small_configs(kind, n_layers=4)
        shapes = dict(param_shapes(tcfg))
        shapes.update({"/".join(k): v for k, v in adapted_shapes(tcfg, 4).items()})
        for k, shape in shapes.items():
            names = tuple(k.split("/"))
            spec = list(plan.param_spec(names, shape))
            while spec and spec[-1] is None:      # JAX trims trailing Nones
                spec.pop()
            assert tuple(spec) == tuple(jplan.param_spec(names, shape)), k


def test_pp_dropout_seeds_fold_step_micro_and_stage():
    """The pipelined step's masks: the same (seed, step) gives the same
    loss bit for bit, another step another; the seeds (and so the masks)
    of every (stage, microbatch, layer) site and the embedding differ;
    one process holding every layer with a pipelined run's per-stage
    count draws that run's seeds (``dropout_sites``)."""
    from building_llm_from_scratch_tpu_torch.models.transformer import build_model
    from building_llm_from_scratch_tpu_torch.ops.philox import flat_keep_mask
    from building_llm_from_scratch_tpu_torch.parallel.pipeline import (
        PipelinePlan,
        dropout_sites,
        make_pp_mesh,
    )
    from building_llm_from_scratch_tpu_torch.training import optim as topt
    from building_llm_from_scratch_tpu_torch.training import train_step as tts

    _, tcfg = small_configs("gpt2", n_layers=4, drop_rate=0.1, context_length=T)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size, (4, T + 1)))
    batch = {"inputs": x[:, :-1], "targets": x[:, 1:]}

    def loss(step):
        plan = PipelinePlan(mesh=make_pp_mesh(1, world_size=1), n_micro=2)
        opt = topt.AdamW(topt.warmup_cosine_schedule(*SCHED))
        state = tts.init_train_state(build_model(tcfg, 1, "cpu"), opt, seed=7, plan=plan)
        state.step = step
        return float(tts.make_pp_train_step(tcfg, opt, plan, dropout_stages=2)(
            state, batch)[1]["loss"])
    assert loss(0) == loss(0) != loss(1)
    seeds = {(s, m, j, site): dropout_sites(5, 0, m, s * 2, 2)(j, site)
             for s in range(2) for m in range(2) for j in range(2)
             for site in ("attention", "residual1", "residual2")}
    seeds.update({("emb", m): dropout_sites(5, 0, m, 0, 2)(-1, "embedding")
                  for m in range(2)})
    assert len(set(seeds.values())) == len(seeds)
    masks = {k: flat_keep_mask(v, (2, 16, 8), 0.1, "cpu") for k, v in seeds.items()}
    ref = masks[(0, 0, 0, "residual1")]
    for k in ((0, 1, 0, "residual1"), (1, 0, 0, "residual1"), (0, 0, 1, "residual1")):
        assert not torch.equal(masks[k], ref), k
    # one process: local layer 3 of 4 is stage 1's layer 1 at two stages
    assert dropout_sites(5, 0, 1, 0, 2)(3, "attention") == seeds[(1, 1, 1, "attention")]


def _pp_base(extra):
    return ["--mode", "train", "--model", "llama3_2", "--num_params", "1B",
            "--debug", "--byte_tokenizer", "--data_dir", ".",
            "--run_type", "multi_chip"] + extra


@pytest.mark.parametrize("flags,error", [
    (["--tp", "2"], r"--tp > 1 requires --shard_mode tp, tp_fsdp or pp\."),
    (["--pp", "2"], r"--pp/--pp_micro only take effect with --shard_mode pp\."),
    (["--pp_micro", "4"], r"--pp/--pp_micro only take effect with --shard_mode pp\."),
    (["--shard_mode", "pp", "--pp_micro", "0"], r"--pp_micro must be >= 1\."),
    (["--shard_mode", "pp", "--pp", "-1"], r"--pp must be >= 0 \(0 = one stage/device\)\."),
    (["--shard_mode", "pp", "--mixed_precision", "fp16"],
     r"--shard_mode pp supports --mixed_precision bf16/fp32 only"),
    (["--shard_mode", "pp", "--mixed_precision", "bf16_hybrid"],
     r"--shard_mode pp supports --mixed_precision bf16/fp32 only"),
    (["--shard_mode", "pp", "--data_type", "fp16"],
     r"--shard_mode pp does not support fp16 \(the pipelined loss has no"),
    (["--shard_mode", "pp", "--sp", "2"], r"--shard_mode pp does not compose with --sp\."),
    (["--shard_mode", "pp", "--batch_size", "6", "--pp_micro", "4"],
     r"--batch_size 6 must be divisible by --pp_micro 4\."),
    (["--shard_mode", "pp", "--batch_size", "8", "--pp_micro", "4", "--grad_accum", "2"],
     r"--grad_accum does not compose with --shard_mode pp \(pipeline microbatching"),
    (["--shard_mode", "pp", "--tp", "2", "--use_lora"],
     r"--use_lora does not compose with --shard_mode pp --tp 2 in the PyTorch port"),
])
def test_pp_flags_raise_in_the_jax_words(flags, error):
    """Every JAX check of ``--shard_mode pp`` (JAX ``args.py:279-281``,
    ``:300-342``) raises in its words; LoRA with pp x tp stays refused
    under the port's LoRA-with-tp words."""
    from building_llm_from_scratch_tpu_torch import args as targs

    with pytest.raises(ValueError, match=error):
        targs.get_args(_pp_base(flags))


def test_pp_flags_are_taken():
    """``--shard_mode pp`` takes ``--pp`` (0: one stage a device),
    ``--pp_micro`` (8 by default, as in JAX) and ``--tp``; a single chip
    refuses it."""
    from building_llm_from_scratch_tpu_torch import args as targs

    args = targs.get_args(_pp_base(["--shard_mode", "pp", "--batch_size", "8"]))
    assert (args.shard_mode, args.pp, args.pp_micro) == ("pp", 0, 8)
    args = targs.get_args(_pp_base(["--shard_mode", "pp", "--pp", "2", "--pp_micro", "4",
                                    "--tp", "2", "--batch_size", "8"]))
    assert (args.pp, args.pp_micro, args.tp) == (2, 4, 2)
    single = [f for f in _pp_base([]) if f not in ("--run_type", "multi_chip")]
    with pytest.raises(ValueError, match="--shard_mode pp requires --run_type multi_chip."):
        targs.get_args(single + ["--shard_mode", "pp", "--batch_size", "8"])


@pytest.mark.parametrize("batch,stages,ok", [(16, 2, True), (8, 2, False), (8, 0, True),
                                             (16, 1, False)])
def test_build_plan_checks_the_microbatch_rows(monkeypatch, batch, stages, ok):
    """``build_plan`` under pp over four ranks: ``--pp`` stages (0: one a
    rank) and the data axis the rest; refused at build time, in the JAX
    words, unless each microbatch's rows divide the data axis."""
    from types import SimpleNamespace

    from building_llm_from_scratch_tpu_torch import build_components
    from building_llm_from_scratch_tpu_torch.parallel import collectives

    monkeypatch.setattr(collectives, "world", lambda: 4)
    monkeypatch.setattr(collectives, "rank", lambda: 3)
    args = SimpleNamespace(run_type="multi_chip", shard_mode="pp", pp=stages, pp_micro=8,
                           tp=1, sp=1, batch_size=batch)
    if not ok:
        with pytest.raises(ValueError, match=r"must split into --pp_micro 8 microbatches "
                                             r"whose rows divide the mesh data axis"):
            build_components.build_plan(args)
        return
    plan = build_components.build_plan(args)
    assert plan.n_stages * plan.n_data == 4 and plan.n_micro == 8
    assert plan.stage_rank == plan.n_stages - 1 and plan.shard_mode == "pp"


#: the health bundle's per-group norms against the JAX step's, first step
HEALTH_NORMS = ("grad_norm", "param_norm", "update_norm", "update_ratio")
HEALTH_RTOL = 1e-5


def _health_err(got: dict, ref: dict) -> float:
    """The largest relative error of the bundle's per-group arrays."""
    return max(float(np.max(np.abs(got[k].astype(np.float64) - ref[f"health/{k}"])
                            / np.abs(ref[f"health/{k}"]).clip(min=1e-30)))
               for k in HEALTH_NORMS)


@pytest.mark.parametrize("part,group", [("llama", "two"), ("gpt2", "two"),
                                        ("lora", "two"), ("data", "four"),
                                        ("tp", "four")])
def test_pp_health_matches_the_jax_bundle(groups, part, group):
    """The first step's per-layer-group health bundle under pp 2 (alone,
    with LoRA, x data 2, x tp 2) against the JAX pp step's on the same mesh
    shape: every rank holds the whole model's vector (its stage's layers
    assembled over the stage axis, each replicated leaf counted once),
    within 1e-5 relative; no group is non-finite. Control (LLaMA-like):
    each rank's bundle of its own stage's leaves, unreduced, fails it."""
    ref = _ref(groups["refs"], part)
    for r in groups[group]:
        h = r[part]["pp"]["metrics"][0]["health"]
        assert h["grad_norm"].shape == ref["health/grad_norm"].shape
        assert _health_err(h, ref) <= HEALTH_RTOL, (part, _health_err(h, ref))
        assert int(h["first_nonfinite"]) == int(ref["health/first_nonfinite"]) == -1
    if part == "llama":
        local = groups["two"][0]["llama"]["localhealth"]["metrics"][0]["health"]
        assert _health_err(local, ref) > HEALTH_RTOL


def _bf16_errors(part, label, files, ref) -> tuple:
    """(the largest per-step loss error, the largest leaf's update error):
    each leaf's ||port - JAX|| over ||JAX - init||, the single-device bf16
    measure of ``test_torch_training.py``."""
    init = flatten_tree(files[2])
    loss = float(np.max(np.abs(np.asarray(_losses(part, label)) - ref["losses"])
                        / np.abs(ref["losses"])))
    upd = 0.0
    for k, v in _params_of(ref).items():
        v = v.astype(np.float64)
        moved = np.linalg.norm(v - np.asarray(init[k], np.float64))
        got = part[label]["whole"][f"trainable/{k}"].astype(np.float64)
        upd = max(upd, np.linalg.norm(got - v) / moved if moved else
                  float(np.any(got != v)))
    return loss, upd


def test_pp_bf16_matches_the_jax_pp_step(groups):
    """pp 2 in bf16 (the LLaMA-like model's parameters, activations and
    gradients, the microbatch gradients summed in bf16 in reverse
    microbatch order by both packages) against the JAX pp step in bf16 on
    2 devices, at the single-device bf16 bounds (``BF16_STEP_TOL``): each
    step's loss within 1e-3 relative, each leaf's total update within 0.15
    of the JAX update's norm; both ranks report the same losses. Control:
    the replicated leaves' gradients summed without the stage axis fail
    the update bound."""
    r0, r1 = (r["llama16"] for r in groups["two"])
    ref = _ref(groups["refs"], "llama16")
    files = groups["llama16"]
    loss, upd = _bf16_errors(r0, "pp", files, ref)
    assert loss <= 1e-3 and upd <= 0.15, (loss, upd)
    assert _losses(r0, "pp") == _losses(r1, "pp")
    _, upd_control = _bf16_errors(r0, "noreduce", files, ref)
    assert upd_control > 0.15, upd_control
