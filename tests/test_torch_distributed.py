"""The port's dp / fsdp / zero1 training in real multi-process gloo groups
on the CPU (``tests/torch_dist_worker.py``, one process per rank, a
``file://`` rendezvous in ``tmp_path`` so concurrent tests never race a
port), against the JAX package's steps on a 2-device CPU mesh over the
same global batch.

Tolerances:
  - against the JAX GSPMD step (``make_train_step`` on
    ``build_mesh_plan(mode, devices=jax.devices()[:2])``): the JAX sharding
    test's, losses rtol 2e-4 atol 2e-5, parameters after three steps rtol
    2e-3 atol 2e-5;
  - bf16_hybrid against the JAX explicit step (``make_sharded_train_step``)
    with each rank on the rows the JAX mesh gives each device (contiguous
    halves): losses rtol 2e-4 atol 2e-5; each leaf's difference within
    1e-3 of its update (relative L2; 1e-4 measured), with every gradient
    reduce counted in bf16. The bf16 rounding of the per-rank gradients
    moves the parameters by about 1e-2 of the update, so the same runs
    with the loader's strided rows (other partial sums rounded) must fail
    the bound;
  - zero1 against dp: bit for bit (the same reduced gradients, the same
    norm, elementwise updates on slices);
  - the sharded runs against one process on the global batch: losses rtol
    2e-4 atol 2e-5, parameters rtol 2e-3 atol 2e-5;
  - checkpoints: bit for bit across packages and world sizes.

Each spawn has its own timeout, after which its processes are killed and
the test fails; one group runs at a time across the test workers.
"""

import contextlib
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.parallel import build_mesh_plan as jplan
from building_llm_from_scratch_tpu.training import checkpoint as jckpt
from building_llm_from_scratch_tpu.training import precision as jprec
from building_llm_from_scratch_tpu.training.optim import (
    build_optimizer,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu.training.train_step import (
    init_train_state as jinit_state,
    make_sharded_train_step as jmake_sharded_step,
    make_train_step as jmake_train_step,
)
from building_llm_from_scratch_tpu_torch.models.lora import flatten_lora, save_adapter
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    export_params,
    flatten_tree,
    lora_from_jax,
    params_from_jax,
)
from torch_dist_worker import launch
from torch_port_helpers import bits, jax_params, make_jax_lora, small_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED = (5e-4, 1e-5, 1e-6, 2, 10)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)


#: the longest a group waits for another worker's group to finish
LOCK_WAIT_S = 900


@contextlib.contextmanager
def one_group_at_a_time(wait_s: float = LOCK_WAIT_S):
    """A lock across test workers: one group of rank processes runs at a
    time, so the suite's other workers keep their cores. Waiting for it
    longer than ``wait_s`` (every holder's group has its own timeout)
    fails the test."""
    import fcntl
    import tempfile
    import time

    with open(os.path.join(tempfile.gettempdir(), "bllm_torch_groups.lock"),
              "w") as f:
        deadline = time.monotonic() + wait_s
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    pytest.fail(f"waited {wait_s} s for another group's lock")
                time.sleep(0.2)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def spawn(tmp_path, spec: dict, world: int, timeout: float = 120) -> list:
    """``torch_dist_worker.launch`` into a fresh directory of ``tmp_path``;
    a failed rank or a group past ``timeout`` (counted once it holds the
    lock) fails the test. Every rank must have run without JAX."""
    out = tmp_path / f"out-{spec['scenario']}-{len(os.listdir(tmp_path))}"
    out.mkdir()
    try:
        with one_group_at_a_time():
            res = launch(spec, world, str(out), timeout)
    except RuntimeError as e:
        pytest.fail(str(e))
    for r in res:
        assert not [m for m in r["modules"] if m.split(".")[0] in (
            "jax", "jaxlib", "building_llm_from_scratch_tpu")]
    return res


def _cfg_json(tcfg) -> dict:
    return dataclasses.asdict(tcfg)


def _setup(tmp_path, kind="llama", seed=3, n_steps=3, rows=4, weights=None,
           **cfg_kw):
    """(jcfg, tcfg, JAX params, numpy params, export path, batches path,
    global batches) of a small model."""
    jcfg, tcfg = small_configs(kind, context_length=32, **cfg_kw)
    params, np_params = jax_params(jcfg, seed=seed)
    export = str(tmp_path / "init.npz")
    export_params(export, params_from_jax(np_params, tcfg, "cpu"))
    rng = np.random.default_rng(1)
    x = rng.integers(0, jcfg.vocab_size, (n_steps, rows, jcfg.context_length + 1))
    data = {"inputs": x[..., :-1].astype(np.int64),
            "targets": x[..., 1:].astype(np.int64)}
    if weights is not None:
        data["weights"] = weights.astype(np.float32)
    bpath = str(tmp_path / "batches.npz")
    np.savez(bpath, **data)
    return jcfg, tcfg, params, np_params, export, bpath, data


def _jax_run(jcfg, params, data, mode, n_steps, policy=None, explicit=False,
             lora=None, n_dev=2, health=None):
    """The JAX step over the global batches on an ``n_dev``-device mesh:
    (losses, final state on the host). The state is placed anew before
    every step, so the step compiles once. ``health``: a list that gets
    each step's health bundle on the host."""
    sched = warmup_cosine_schedule(*SCHED)
    opt = build_optimizer(schedule=sched)
    plan = jplan(mode, devices=jax.devices()[:n_dev])
    kw = {}
    if lora is not None:
        state = jinit_state(lora["tree"], opt, jax.random.PRNGKey(0),
                            frozen=params, policy=policy)
        kw = dict(lora_alpha=lora["alpha"], lora_rank=lora["rank"])
    else:
        state = jinit_state(params, opt, jax.random.PRNGKey(0), policy=policy)
    if explicit:
        step = jmake_sharded_step(jcfg, opt, plan, lr_schedule=sched,
                                  policy=policy, **kw)
    else:
        step = jmake_train_step(jcfg, opt, lr_schedule=sched, policy=policy,
                                **kw)
    losses = []
    for i in range(n_steps):
        batch = {"inputs": data["inputs"][i].astype(np.int32),
                 "targets": data["targets"][i].astype(np.int32)}
        batch["weights"] = (data["weights"][i] if "weights" in data
                            else np.ones(batch["targets"].shape, np.float32))
        state, m = step(plan.shard_state(state), plan.shard_batch(batch))
        losses.append(float(m["loss"]))
        if health is not None:
            health.append(jax.device_get(m["health"]))
    return losses, jax.device_get(state)


def _health_err(got: dict, want: dict) -> float:
    """The largest relative error of a health bundle's per-group arrays."""
    return max(float(np.max(np.abs(got[k].astype(np.float64) - np.asarray(want[k]))
                            / np.abs(np.asarray(want[k], np.float64)).clip(min=1e-30)))
               for k in ("grad_norm", "param_norm", "update_norm", "update_ratio"))


def _spec(export, bpath, tcfg, runs, steps=3, **kw):
    return dict(scenario="steps", cfg=_cfg_json(tcfg), params=export,
                batches=bpath, sched=list(SCHED), seed=0, steps=steps,
                runs=runs, **kw)


def _losses(res, label):
    return [m["loss"] for m in res[label]["metrics"]]


def test_modes_match_the_jax_gspmd_step(tmp_path):
    """World 2, LLaMA-like fp32, three steps under dp, fsdp and zero1
    against the JAX GSPMD step on a 2-device mesh over the same global
    batches (losses and parameters at the JAX test's tolerances); zero1
    bit-equal to dp; both ranks hold the same whole parameters; the
    per-rank moments of fsdp and zero1 are half of dp's up to the
    replicated small leaves; between steps fsdp has freed its sharded
    leaves' working copy and gradients and holds less than zero1, which
    holds less than dp; the counters show fsdp's gathers and
    reduce-scatters. Every step's per-layer-group health bundle: the
    first's within 1e-5 relative of the JAX step's on every rank (fsdp's
    shards summed over the data axis, replicated leaves once). Control:
    each rank stepping alone on its rows (no gradient reduce) fails the
    parameter bound and the health bound."""
    jcfg, tcfg, params, np_params, export, bpath, data = _setup(tmp_path)
    runs = [["dp", "dp", None], ["fsdp", "fsdp", None], ["zero1", "zero1", None],
            ["control", "control", None]]
    res = spawn(tmp_path, _spec(export, bpath, tcfg, runs), world=2)
    r0, r1 = res
    jax_dp = None
    for mode in ("dp", "fsdp", "zero1"):
        jh = []
        jl, js = _jax_run(jcfg, params, data, mode, 3, health=jh)
        jax_dp = jax_dp or js
        for r in res:
            assert _health_err(r[mode]["metrics"][0]["health"], jh[0]) <= 1e-5, mode
        if mode == "dp":
            assert _health_err(r0["control"]["metrics"][0]["health"], jh[0]) > 1e-5
        np.testing.assert_allclose(_losses(r0, mode), jl, **LOSS_TOL)
        assert _losses(r0, mode) == _losses(r1, mode)
        want = flatten_tree(js["trainable"])
        for k, v in want.items():
            got = r0[mode]["whole"][f"trainable/{k}"]
            np.testing.assert_allclose(got, np.asarray(v), **PARAM_TOL,
                                       err_msg=f"{mode} {k}")
            np.testing.assert_array_equal(bits(got),
                                          bits(r1[mode]["whole"][f"trainable/{k}"]))
    for k, v in r0["dp"]["whole"].items():
        np.testing.assert_array_equal(bits(r0["zero1"]["whole"][k]), bits(v),
                                      err_msg=k)
    assert _losses(r0, "zero1") == _losses(r0, "dp")
    small = sum(2 * np.asarray(v).nbytes for v in flatten_tree(np_params).values()
                if np.asarray(v).size < 1024)
    dp_bytes = r0["dp"]["moment_bytes"]
    for mode in ("fsdp", "zero1"):
        for r in res:
            assert abs(r[mode]["moment_bytes"] - dp_bytes / 2) <= small / 2, mode
    # between steps fsdp holds no working copy or gradients of its sharded
    # leaves: less than zero1, which holds both whole
    for r in res:
        assert r["fsdp"]["sharded"] and r["fsdp"]["freed"] == r["fsdp"]["sharded"]
        assert r["zero1"]["sharded"] == [] and r["dp"]["freed"] == []
        assert r["fsdp"]["resident_bytes"] < r["zero1"]["resident_bytes"] \
            < r["dp"]["resident_bytes"]
    c = r0["fsdp"]["counters"]
    assert c["all_gather/fp32"]["calls"] > 0 and c["reduce_scatter/fp32"]["calls"] > 0
    assert "reduce_scatter/fp32" not in r0["dp"]["counters"]
    # the control: no reduce, so each rank's parameters leave the JAX run's
    want = flatten_tree(jax_dp["trainable"])
    worst = max(np.max(np.abs(r0["control"]["rank_params"][k] - np.asarray(v))
                       - PARAM_TOL["rtol"] * np.abs(np.asarray(v)))
                for k, v in want.items())
    assert worst > PARAM_TOL["atol"], worst


def test_bf16_hybrid_reduces_in_bf16_like_the_jax_explicit_step(tmp_path):
    """bf16_hybrid at world 2 under dp, fsdp and zero1 against the JAX
    ``make_sharded_train_step`` (the module docstring's bounds): every
    gradient reduce moves bf16 (one per trainable leaf and step), none
    moves fp32 gradients; the control with the strided rows fails."""
    jcfg, tcfg, params, np_params, export, bpath, data = _setup(tmp_path)
    same = {"contiguous_rows": True}
    runs = [[m, m, "bf16_hybrid", same] for m in ("dp", "fsdp", "zero1")]
    runs.append(["strided", "dp", "bf16_hybrid"])
    res = spawn(tmp_path, _spec(export, bpath, tcfg, runs), world=2)
    init = {k: np.asarray(v, np.float32) for k, v in flatten_tree(np_params).items()}
    n_leaves = len(init)

    def worst(label, js):
        out = 0.0
        for k, v in flatten_tree(js["trainable"]).items():
            got = res[0][label]["whole"][f"trainable/{k}"]
            moved = np.linalg.norm(np.asarray(v) - init[k])
            out = max(out, np.linalg.norm(got - np.asarray(v)) / moved)
        return out

    for mode in ("dp", "fsdp", "zero1"):
        jl, js = _jax_run(jcfg, params, data, mode, 3,
                          policy=jprec.get_policy("bf16_hybrid"), explicit=True)
        np.testing.assert_allclose(_losses(res[0], mode), jl, **LOSS_TOL)
        assert worst(mode, js) <= 1e-3, mode
        c = res[0][mode]["counters"]
        bf16 = sum(c.get(f"{op}/bf16", {}).get("calls", 0)
                   for op in ("all_reduce", "reduce_scatter"))
        assert bf16 == 3 * n_leaves, (mode, c)
        assert "reduce_scatter/fp32" not in c, c
        # fp32 all-reduces are the scalars only: weight sum, loss and (fsdp)
        # the norms' vectors
        assert c["all_reduce/fp32"]["bytes"] < 1024, c
        if mode == "dp":
            assert worst("strided", js) > 1e-3


def test_sft_with_unequal_masks_matches_the_global_mean(tmp_path):
    """LoRA SFT (adapter sharded under fsdp, base frozen) at world 2 whose
    two ranks supervise very different token counts: under fsdp and dp the
    losses and the adapter after three steps equal the JAX GSPMD step's
    on a 2-device mesh in the same mode over the global batches (the
    sharded tolerances), the base stays bit-unchanged; the mean of the
    ranks' own means (what a per-rank mean averaged over ranks would
    report) misses the global loss."""
    T = 32
    w = np.zeros((3, 4, T), np.float32)
    w[:, 0::2, 4:] = 1.0      # rank 0's rows: 28 targets each
    w[:, 1::2, 30:] = 1.0     # rank 1's rows: 2 targets each
    jcfg, tcfg, params, np_params, export, bpath, data = _setup(tmp_path,
                                                                weights=w)
    jl = make_jax_lora(jcfg, params, seed=5, rank=4)
    lpath = str(tmp_path / "lora.npz")
    save_adapter(lpath, lora_from_jax(jax.device_get(jl), tcfg, "cpu"), rank=4,
                 alpha=8.0, cfg=tcfg)
    lora = dict(path=lpath, rank=4, alpha=8.0)
    res = spawn(tmp_path, _spec(export, bpath, tcfg,
                                [["fsdp", "fsdp", None], ["dp", "dp", None]],
                                lora=lora, eval=True), world=2)
    first = None
    for mode in ("fsdp", "dp"):
        jlosses, js = _jax_run(jcfg, params, data, mode, 3,
                               lora=dict(tree=jl, alpha=8.0, rank=4))
        first = first or jlosses[0]
        np.testing.assert_allclose(_losses(res[0], mode), jlosses, **LOSS_TOL)
        want = flatten_lora(lora_from_jax(js["trainable"], tcfg, "cpu"))
        for path, v in want.items():
            k = "/".join(path)
            np.testing.assert_allclose(res[0][mode]["whole"][f"trainable/{k}"],
                                       v.numpy(), **PARAM_TOL, err_msg=f"{mode} {k}")
        for k, v in flatten_tree(np_params).items():
            np.testing.assert_array_equal(
                bits(res[0][mode]["whole"][f"frozen/{k}"]), bits(np.asarray(v)))
    # the first step's loss from the initial adapter, per rank
    model = params_from_jax(np_params, tcfg, "cpu")
    lt = lora_from_jax(jax.device_get(jl), tcfg, "cpu")
    ev = tts.make_eval_step(tcfg, lora_alpha=8.0, lora_rank=4)
    st = tts.init_train_state(lt, topt.AdamW(topt.warmup_cosine_schedule(*SCHED)),
                              frozen=model)
    per_rank = [float(ev(st, {k: torch.from_numpy(v[0][r::2])
                              for k, v in data.items()})) for r in range(2)]
    assert abs(np.mean(per_rank) - first) > (
        LOSS_TOL["rtol"] * abs(first) + LOSS_TOL["atol"]), per_rank


def test_fp16_overflow_on_one_ranks_shard_skips_on_both(tmp_path):
    """fp16 policy under fsdp at world 2, rank 0's reduced gradient shard
    poisoned with inf at step 1: both ranks skip that step and halve the
    scale, the others update, and both end with the same parameters, those
    of a run that never saw step 1's update."""
    jcfg, tcfg, params, np_params, export, bpath, data = _setup(tmp_path)
    res = spawn(tmp_path, _spec(export, bpath, tcfg, [["fsdp", "fsdp", "fp16"]],
                                overflow=dict(rank=0, step=1)), world=2)
    for r in res:
        m = r["fsdp"]["metrics"]
        assert [x["skipped"] for x in m] == [0, 1, 0]
        assert m[1]["loss_scale"] == m[0]["loss_scale"] / 2
    for k, v in res[0]["fsdp"]["whole"].items():
        np.testing.assert_array_equal(bits(v), bits(res[1]["fsdp"]["whole"][k]))


def test_world_four_zero1_matches_one_process(tmp_path):
    """zero1 over four ranks (one row each) against one JAX process: its
    GSPMD step on a 4-device mesh over the global batches (losses and
    parameters at the JAX test's tolerances), with a quarter of the
    moments per rank up to the replicated small leaves."""
    jcfg, tcfg, params, np_params, export, bpath, data = _setup(tmp_path)
    res = spawn(tmp_path, _spec(export, bpath, tcfg, [["zero1", "zero1", None]]),
                world=4, timeout=180)
    jlosses, js = _jax_run(jcfg, params, data, "zero1", 3, n_dev=4)
    np.testing.assert_allclose(_losses(res[0], "zero1"), jlosses, **LOSS_TOL)
    want = {k: np.asarray(v) for k, v in flatten_tree(js["trainable"]).items()}
    for r in res:
        assert _losses(r, "zero1") == _losses(res[0], "zero1")
        for k, v in want.items():
            np.testing.assert_allclose(r["zero1"]["whole"][f"trainable/{k}"], v,
                                       **PARAM_TOL, err_msg=k)
    full = sum(2 * v.nbytes for v in want.values())
    small = sum(2 * v.nbytes for v in want.values() if v.size < 1024)
    for r in res:
        assert abs(r["zero1"]["moment_bytes"] - full / 4) <= small


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return {leaf["path"]: leaf for leaf in json.load(f)["leaves"]}


def test_fsdp_checkpoints_cross_over_with_jax(tmp_path):
    """A port fsdp checkpoint of 2 ranks has the JAX 2-device fsdp save's
    leaves, shapes, dtypes and shard indices; JAX's ``load_checkpoint``
    restores it bit for bit, and so does one port process; a JAX 2-device
    fsdp save restores onto 2 port ranks bit for bit."""
    jcfg, tcfg, params, np_params, export, bpath, data = _setup(tmp_path)
    save = tmp_path / "ckpts"
    save.mkdir()
    res = spawn(tmp_path, _spec(export, bpath, tcfg, [["fsdp", "fsdp", None]],
                                save=str(save), steps=1), world=2)
    port_ck = str(save / "fsdp")
    whole = res[0]["fsdp"]["whole"]

    _, js = _jax_run(jcfg, params, data, "fsdp", 1)
    sched = warmup_cosine_schedule(*SCHED)
    plan = jplan("fsdp", devices=jax.devices()[:2])
    jstate = plan.shard_state(js)
    jax_ck = str(tmp_path / "jax-ck")
    jckpt.save_checkpoint(jax_ck, jstate, extra_metadata={"global_step": 1})
    pm, jm = _manifest(port_ck), _manifest(jax_ck)
    assert list(pm) == list(jm)
    for path, leaf in jm.items():
        for key in ("shape", "dtype"):
            assert pm[path][key] == leaf[key], (path, key)
        assert [sh["index"] for sh in pm[path]["shards"]] == \
            [sh["index"] for sh in leaf["shards"]], path
    assert any(len(leaf["shards"]) == 2 for leaf in pm.values())

    template = plan.shard_state(jinit_state(params, build_optimizer(schedule=sched),
                                            jax.random.PRNGKey(0)))
    loaded = jckpt.load_checkpoint(port_ck, template)
    flat = {jckpt._path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(loaded))[0]}
    for k, v in whole.items():
        jk = k if k.startswith("trainable/") else f"opt_state/1/{k}"
        np.testing.assert_array_equal(bits(flat[jk]), bits(v), err_msg=k)
    assert int(flat["step"]) == 1

    model = params_from_jax(np_params, tcfg, "cpu")
    one = tts.init_train_state(model, topt.AdamW(topt.warmup_cosine_schedule(*SCHED)))
    tts.restore_train_state(one, port_ck)
    for k, v in one.full.items():
        np.testing.assert_array_equal(bits(v), bits(whole[f"trainable/{k}"]),
                                      err_msg=k)
        for name in ("mu", "nu"):
            np.testing.assert_array_equal(
                bits(getattr(one.opt_state, name)[k]), bits(whole[f"{name}/{k}"]),
                err_msg=k)
    assert one.step == 1 and one.opt_state.count == 1

    back = spawn(tmp_path, _spec(export, bpath, tcfg, [["fsdp", "fsdp", None]],
                                 load=jax_ck), world=2)
    want = {jckpt._path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(js)[0]}
    for r in back:
        assert r["fsdp"]["step"] == 1 and r["fsdp"]["count"] == 1
        for k, v in r["fsdp"]["whole"].items():
            jk = k if k.startswith("trainable/") else f"opt_state/1/{k}"
            np.testing.assert_array_equal(bits(v), bits(want[jk]), err_msg=k)


TEXT = ("Every effort moves you closer to mastery. " * 40
        + "A quick brown fox jumps over the lazy dog. " * 20)


def _cli_flags(tmp_path, n_steps, extra=()):
    """Debug LLaMA fp32 from a JAX export, a corpus sized for ``n_steps``
    global batches of 8 windows."""
    from building_llm_from_scratch_tpu.configs import get_config as jget_config
    from building_llm_from_scratch_tpu.models import init_params as jinit

    d = tmp_path / "data"
    if not d.exists():
        d.mkdir()
        jcfg = jget_config("llama3_2", "1B", dtype="fp32", debug=True)
        T = jcfg.context_length
        # byte tokens: the train split (90% of the text + the eos suffix)
        # holds n_steps x 8 windows of T and a little more
        n_chars = int((n_steps * 8 * T + T // 2) / 0.9) - 15
        (d / "corpus.txt").write_text((TEXT * 10)[:n_chars])
        jckpt.export_params(str(tmp_path / "init.npz"),
                            jinit(jcfg, jax.random.PRNGKey(5)))
    return ["--mode", "train", "--model", "llama3_2", "--num_params", "1B",
            "--debug", "--byte_tokenizer", "--data_type", "fp32",
            "--n_epochs", "1", "--warmup_steps", "2",
            "--init_params_from", str(tmp_path / "init.npz"),
            "--data_dir", str(d), *extra]


def test_cli_modes_match_the_jax_cli(tmp_path, monkeypatch):
    """``main.run --run_type multi_chip --shard_mode dp|fsdp|zero1
    --device cpu`` as two ranks under torchrun's environment (batch 4 per
    rank) against the JAX CLI with ``--run_type multi_chip`` over the
    test mesh (batch 8 on one process): the evaluation after three steps
    (train and validation losses, the sharded tolerance), the final export
    (the parameter tolerance), the per-rank token count (half the JAX
    process's), the warm-up sample on rank 0 only."""
    from building_llm_from_scratch_tpu import main as jmain

    flags = _cli_flags(tmp_path, 3, ["--eval_freq", "3",
                                     "--print_sample_iter", "1000"])
    monkeypatch.setattr(jmain, "plot_losses", lambda *a, **kw: None)
    jt = jmain.run(flags + ["--batch_size", "8", "--run_type", "multi_chip",
                            "--output_dir", str(tmp_path / "jout"),
                            "--save_ckpt_freq", "1000"])
    assert jt.global_step == 3
    runs = [[m, flags + ["--batch_size", "4", "--device", "cpu",
                         "--run_type", "multi_chip", "--shard_mode", m,
                         "--output_dir", str(tmp_path / f"tout-{m}")]]
            for m in ("dp", "fsdp", "zero1")]
    res = spawn(tmp_path, dict(scenario="cli", runs=runs), world=2, timeout=180)
    from building_llm_from_scratch_tpu.models import init_params as jinit

    jx = jckpt.load_exported_params(str(tmp_path / "jout" / "model_pg_final.npz"),
                                    jinit(jax_cfg_debug(), jax.random.PRNGKey(0)))
    want = flatten_tree(jax.device_get(jx))
    for m, _ in runs:
        r0, r1 = res[0][m], res[1][m]
        assert r0["global_step"] == r1["global_step"] == 3
        np.testing.assert_allclose(r0["train_losses"], jt.train_losses, **LOSS_TOL)
        np.testing.assert_allclose(r0["val_losses"], jt.val_losses, **LOSS_TOL)
        assert r0["losses"] == r1["losses"]
        assert 2 * r0["tokens_seen"] == jt.tokens_seen
        assert len(r0["samples"]) == 1 and r1["samples"] == []
        got = jckpt.load_exported_params(
            str(tmp_path / f"tout-{m}" / "model_pg_final.npz"),
            jinit(jax_cfg_debug(), jax.random.PRNGKey(0)))
        for k, v in flatten_tree(jax.device_get(got)).items():
            np.testing.assert_allclose(np.asarray(v), np.asarray(want[k]),
                                       **PARAM_TOL, err_msg=f"{m} {k}")


def jax_cfg_debug():
    from building_llm_from_scratch_tpu.configs import get_config as jget_config

    return jget_config("llama3_2", "1B", dtype="fp32", debug=True)


def test_sigterm_on_one_rank_stops_both_and_resumes_bit_equal(tmp_path):
    """fsdp through the CLI at world 2, 10 steps: SIGTERM to rank 1 after
    step 3 stops both ranks at the same step (the agreement every 8 polls:
    step 8) with an ``interrupted`` checkpoint holding the same cursor;
    the same command resumes from it and repeats the unbroken run's
    remaining losses bit for bit (deterministic algorithms)."""
    base = _cli_flags(tmp_path, 10, ["--batch_size", "4", "--device", "cpu",
                                     "--run_type", "multi_chip",
                                     "--shard_mode", "fsdp", "--eval_freq", "1000",
                                     "--print_sample_iter", "1000",
                                     "--save_ckpt_freq", "1000"])
    a = base + ["--output_dir", str(tmp_path / "a"), "--resume", "off"]
    b = base + ["--output_dir", str(tmp_path / "b")]
    runs = [["unbroken", a], ["stopped", b], ["resumed", b]]
    res = spawn(tmp_path, dict(scenario="cli", runs=runs, deterministic=True,
                               sigterm=dict(run="stopped", rank=1, after_step=3)),
                world=2, timeout=240)
    for r in res:
        assert r["unbroken"]["global_step"] == 10
        assert r["stopped"]["preempted"] and r["stopped"]["global_step"] == 8
        assert r["resumed"]["restored"]["step"] == 8
        assert r["resumed"]["losses"] == r["unbroken"]["losses"][8:]
        assert r["resumed"]["global_step"] == 10
    assert res[0]["stopped"]["cursor"] == res[1]["stopped"]["cursor"]
    assert os.path.isdir(tmp_path / "b" / "model_pg_interrupted")
