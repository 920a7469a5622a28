"""The port's training telemetry against the JAX package's: the
per-layer-group health bundle (``obs/health.py``) of every single-device
step builder, the MFU arithmetic (``obs/mfu.py``), the step timeline
(``obs/timeline.py``), the trace export (``obs/trace.py``), the event
registry, and the ``--mode train`` CLI's JSONL (``--metrics_jsonl``,
``--log_every``, ``--stall_timeout``, ``--profile``). The sharded steps'
bundles are held in the multi-rank files (``test_torch_distributed.py``,
``test_torch_tensor_parallel.py``, ``test_torch_pipeline.py``).

Tolerances:
  - the health function on the same tensors (the gradients, updated
    parameters and updates a port step made, fed to JAX ``group_health``):
    every per-group array within 1e-5 relative (fp32 and bf16 leaves; both
    sum squares in fp32, in another order: the update norms, sums of ~65k
    near-equal squares, differ by up to 4.1e-6 in fp32 and 8.7e-6 over bf16
    leaves, the gradient and parameter norms by under 1e-6); control: one
    group's gradients scaled by 1 + 3e-5 fail it;
  - a port step's bundle against the JAX step's on the same weights and
    batch (fp32): gradient and parameter norms within 1e-5 relative, update
    norms and ratios within 1e-4 (the step tests' bounds on the global
    norms); bf16 steps (a bf16 model, the bf16 policy) within 1e-2
    (``BF16_STEP_TOL``'s norm bound); the group names equal; control: the
    parameter norms taken before the update fail the fp32 bound;
  - MFU, FLOPs a token, the timeline and the trace: exact.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu import configs as jcfgs
from building_llm_from_scratch_tpu.obs import health as jhealth
from building_llm_from_scratch_tpu.obs import mfu as jmfu
from building_llm_from_scratch_tpu.obs import schema as jschema
from building_llm_from_scratch_tpu.obs import timeline as jtimeline
from building_llm_from_scratch_tpu.obs import trace as jtrace
from building_llm_from_scratch_tpu.training import precision as jprec
from building_llm_from_scratch_tpu.training.optim import (
    build_optimizer,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu.training.train_step import (
    init_train_state as jinit_state,
)
from building_llm_from_scratch_tpu.training.train_step import (
    make_train_step as jmake_train_step,
)
from building_llm_from_scratch_tpu_torch import configs as tcfgs
from building_llm_from_scratch_tpu_torch.models.lora import flatten_lora
from building_llm_from_scratch_tpu_torch.obs import health as thealth
from building_llm_from_scratch_tpu_torch.obs import metrics as tmetrics
from building_llm_from_scratch_tpu_torch.obs import mfu as tmfu
from building_llm_from_scratch_tpu_torch.obs import schema as tschema
from building_llm_from_scratch_tpu_torch.obs import timeline as ttimeline
from building_llm_from_scratch_tpu_torch.obs import trace as ttrace
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import precision as tprec
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    flatten_tree,
    lora_from_jax,
    params_from_jax,
)
from torch_port_helpers import jax_params, make_jax_lora, small_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED = (1e-3, 1e-5, 1e-6, 2, 10)
ARRAYS = ("grad_norm", "param_norm", "update_norm", "update_ratio")
#: the health function on the same tensors (module docstring)
FUNC_RTOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b).clip(min=1e-30)))


def _nested(flat: dict) -> dict:
    """A port flat tree ('blocks/attn/wq': tensor) as the JAX nested dict
    of jax arrays (bf16 kept bf16)."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = v.detach()
        arr = jnp.asarray(t.float().numpy())
        node[parts[-1]] = arr.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else arr
    return out


def _batch(jcfg, rows=4, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    T = jcfg.context_length
    x = rng.integers(0, jcfg.vocab_size, (rows, T + 1))
    w = np.ones((rows, T), np.float32)
    if masked:
        for r in range(rows):
            w[r, : int(rng.integers(T // 4, 3 * T // 4))] = 0.0
    return x[:, :-1], x[:, 1:], w


class _Captured:
    """Records what a port step hands its health accumulator (clones of
    the gradients before the clip, the updates and the new parameters)."""

    def __init__(self, monkeypatch):
        self.trees: dict = {}
        orig = thealth.GroupSums.add

        def add(sums, kind, tree, _orig=orig):
            self.trees[kind] = {k: v.detach().clone() for k, v in tree.items()}
            return _orig(sums, kind, tree)
        monkeypatch.setattr(thealth.GroupSums, "add", add)


def _port_step(tcfg, np_params, batch, *, policy=None, grad_accum=1, lora=None,
               mutate=None):
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(*SCHED))
    kw = {}
    if lora is not None:
        state = tts.init_train_state(lora["tree"], opt, frozen=model, policy=policy)
        kw = dict(lora_alpha=lora["alpha"], lora_rank=lora["rank"])
    else:
        state = tts.init_train_state(model, opt, policy=policy)
    if mutate is not None:
        mutate(state)
    step = tts.make_train_step(tcfg, opt, policy=policy, grad_accum=grad_accum, **kw)
    x, y, w = batch
    state, m = step(state, {"inputs": torch.from_numpy(x),
                            "targets": torch.from_numpy(y),
                            "weights": torch.from_numpy(w)})
    return state, m


def _jax_step(jcfg, params, batch, *, policy=None, grad_accum=1, lora=None,
              mutate=None):
    sched = warmup_cosine_schedule(*SCHED)
    opt = build_optimizer(schedule=sched)
    kw = {}
    if lora is not None:
        state = jinit_state(lora["tree"], opt, jax.random.PRNGKey(0), frozen=params,
                            policy=policy)
        kw = dict(lora_alpha=lora["alpha"], lora_rank=lora["rank"])
    else:
        state = jinit_state(params, opt, jax.random.PRNGKey(0), policy=policy)
    if mutate is not None:
        state = mutate(state)
    step = jmake_train_step(jcfg, opt, lr_schedule=sched, policy=policy,
                            grad_accum=grad_accum, **kw)
    x, y, w = batch
    state, m = step(state, {"inputs": jnp.asarray(x, jnp.int32),
                            "targets": jnp.asarray(y, jnp.int32),
                            "weights": jnp.asarray(w)})
    return state, jax.device_get(m)


def _case(name):
    """(jcfg, tcfg, jax params, numpy params, kwargs of both steps, batch)."""
    dtype = "bf16" if name == "bf16" else "fp32"
    kind = "gpt2" if name == "gpt2" else "llama"
    jcfg, tcfg = small_configs(kind, dtype=dtype, context_length=32)
    params, np_params = jax_params(jcfg, seed=3)
    jkw, tkw = {}, {}
    if name == "lora":
        jl = make_jax_lora(jcfg, params, seed=7, rank=4)
        jkw["lora"] = dict(tree=jl, alpha=8.0, rank=4)
        tkw["lora"] = dict(tree=lora_from_jax(jax.device_get(jl), tcfg, "cpu"),
                           alpha=8.0, rank=4)
    if name == "accum":
        jkw["grad_accum"] = tkw["grad_accum"] = 2
    if name == "policy":
        jkw["policy"] = jprec.get_policy("bf16")
        tkw["policy"] = tprec.get_policy("bf16")
    return jcfg, tcfg, params, np_params, jkw, tkw, _batch(jcfg, masked=name == "accum")


CASES = ["fp32", "gpt2", "bf16", "lora", "accum", "policy"]


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_group_names_match_jax(kind):
    """The group names of the model tree and of a LoRA adapter: sorted
    top-level keys, ``blocks`` expanded to block_00.. (JAX ``group_names``)."""
    jcfg, tcfg = small_configs(kind, n_layers=3)
    params, np_params = jax_params(jcfg, seed=1)
    model = params_from_jax(np_params, tcfg, "cpu")
    assert thealth.group_names(model.stacked) == jhealth.group_names(params)
    jl = make_jax_lora(jcfg, params, seed=2, rank=4)
    tl = lora_from_jax(jax.device_get(jl), tcfg, "cpu")
    flat = {"/".join(p): v for p, v in flatten_lora(tl).items()}
    assert thealth.group_names(flat) == jhealth.group_names(jl)
    assert [n for n in thealth.group_names(flat) if n.startswith("block_")] == [
        "block_00", "block_01", "block_02"]


@pytest.mark.parametrize("case", CASES)
def test_health_function_matches_jax_group_health(case, monkeypatch):
    """The port's bundle of one step against JAX ``group_health`` fed the
    very gradients (pre-clip), updated parameters and updates that step
    made: every array within 1e-6 relative, the same first_nonfinite (-1);
    the per-group norms compose to the step's global grad_norm and
    update_norm. Control: one group's gradients scaled by 1 + 1e-5 fail
    the bound."""
    jcfg, tcfg, params, np_params, jkw, tkw, batch = _case(case)
    cap = _Captured(monkeypatch)
    _, m = _port_step(tcfg, np_params, batch, **tkw)
    g, p, u = (cap.trees[k] for k in ("grad", "param", "update"))
    want = jax.device_get(jhealth.group_health(_nested(g), _nested(p), _nested(u)))
    got = {k: v.numpy() for k, v in m["health"].items()}
    for k in ARRAYS:
        assert got[k].shape == (len(thealth.group_names(p, tcfg.n_layers)),)
        assert _rel(got[k], want[k]) <= FUNC_RTOL, (case, k, _rel(got[k], want[k]))
    assert int(got["first_nonfinite"]) == int(want["first_nonfinite"]) == -1
    np.testing.assert_allclose(np.sqrt(np.sum(got["grad_norm"].astype(np.float64) ** 2)),
                               float(m["grad_norm"]), rtol=1e-2 if case == "bf16" else 1e-5)
    np.testing.assert_allclose(np.sqrt(np.sum(got["update_norm"].astype(np.float64) ** 2)),
                               float(m["update_norm"]), rtol=1e-2 if case == "bf16" else 1e-5)
    # control: one group's gradients 3e-5 larger are caught
    top = sorted(g)[-1].split("/")[0]
    g2 = {k: v.float() * (1 + 3e-5) if k.startswith(top + "/") else v
          for k, v in g.items()}
    control = jax.device_get(jhealth.group_health(_nested(g2), _nested(p), _nested(u)))
    assert _rel(got["grad_norm"], control["grad_norm"]) > FUNC_RTOL


@pytest.mark.parametrize("case", CASES)
def test_step_health_matches_the_jax_step(case):
    """One port step against one JAX step (``make_train_step``: alone, with
    a LoRA adapter, ``grad_accum`` 2 on prompt-masked rows, the bf16 policy,
    a bf16 model) on the same weights and batch: the bundle's arrays at the
    module's step bounds, the same group count. Control (fp32): the
    parameter norms of the weights before the update fail the bound."""
    jcfg, tcfg, params, np_params, jkw, tkw, batch = _case(case)
    state, m = _port_step(tcfg, np_params, batch, **tkw)
    _, jm = _jax_step(jcfg, params, batch, **jkw)
    got = {k: v.numpy() for k, v in m["health"].items()}
    want = jm["health"]
    bf16 = case in ("bf16", "policy")
    tol = {"grad_norm": 1e-5, "param_norm": 1e-5, "update_norm": 1e-4,
           "update_ratio": 1e-4}
    for k in ARRAYS:
        assert got[k].shape == np.asarray(want[k]).shape
        bound = 1e-2 if bf16 else tol[k]
        assert _rel(got[k], want[k]) <= bound, (case, k, _rel(got[k], want[k]))
    assert int(got["first_nonfinite"]) == int(want["first_nonfinite"]) == -1
    if case == "fp32":
        before = params_from_jax(np_params, tcfg, "cpu").stacked
        stale = thealth.group_norms(before).numpy()
        assert _rel(stale, want["param_norm"]) > 1e-5


def test_health_first_nonfinite_names_the_injected_layer():
    """A NaN in one block's gradient leaf: both packages' ``group_health``
    name that block (hand-built trees: JAX tests/test_training.py), and the
    norms of the other groups stay equal; ``describe_health`` and the
    health row's name agree."""
    rng = np.random.default_rng(0)
    tree = {"blocks/attn/wq": rng.standard_normal((3, 4, 4)).astype(np.float32),
            "blocks/norm1/scale": rng.standard_normal((3, 4)).astype(np.float32),
            "head/weight": rng.standard_normal((4, 6)).astype(np.float32),
            "tok_emb/weight": rng.standard_normal((6, 4)).astype(np.float32)}
    grads = {k: v.copy() for k, v in tree.items()}
    grads["blocks/attn/wq"][1, 2, 3] = np.nan
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    got = thealth.group_health(t(grads), t(tree), t(tree))
    want = jax.device_get(jhealth.group_health(_nested(t(grads)), _nested(t(tree)),
                                               _nested(t(tree))))
    names = thealth.group_names(t(tree))
    assert names == ["block_00", "block_01", "block_02", "head", "tok_emb"]
    assert int(got["first_nonfinite"]) == int(want["first_nonfinite"]) == 1
    fetched = thealth.fetch_health(got)
    assert thealth.nonfinite_group_name(names, fetched) == "block_01"
    assert thealth.describe_health(names, fetched)["first_nonfinite_group"] == "block_01"
    assert jhealth.describe_health(names, want)["first_nonfinite_group"] == "block_01"
    ok = [0, 2, 3, 4]
    assert _rel(fetched["grad_norm"][ok], want["grad_norm"][ok]) <= 1e-6
    assert np.isnan(fetched["grad_norm"][1]) and np.isnan(want["grad_norm"][1])
    # a huge but finite group is not non-finite (its square sum overflows)
    big = dict(tree, **{"head/weight": np.full((4, 6), 1e30, np.float32)})
    assert int(thealth.group_health(t(big), t(tree), t(tree))["first_nonfinite"]) == -1
    assert thealth.health_summary_line(names, fetched).startswith("health: max grad")


def test_fp16_skipped_step_reports_the_discarded_update():
    """An overflowing fp16 step (head + 1e5, both packages' fp16 policy):
    the port skips it and keeps its parameters, and its bundle is built, as
    JAX's, from the non-finite gradients and the update it discards: the
    same first non-finite group, the same non-finite pattern in every
    array, the finite entries within 1e-4."""
    jcfg, tcfg = small_configs("gpt2", context_length=32)
    params, np_params = jax_params(jcfg, seed=1)
    batch = _batch(jcfg)

    def bump_port(state):
        with torch.no_grad():
            state.params["head/weight"].add_(1e5)

    def bump_jax(state):
        tr = dict(state["trainable"])
        tr["head"] = {"weight": tr["head"]["weight"] + 1e5}
        return dict(state, trainable=tr)

    state, m = _port_step(tcfg, np_params, batch, policy=tprec.get_policy("fp16"),
                          mutate=bump_port)
    _, jm = _jax_step(jcfg, params, batch, policy=jprec.get_policy("fp16"),
                      mutate=bump_jax)
    assert m["skipped"] == 1 and not np.isfinite(float(jm["grad_norm"]))
    got = {k: v.numpy() for k, v in m["health"].items()}
    want = jm["health"]
    assert int(got["first_nonfinite"]) == int(want["first_nonfinite"]) >= 0
    for k in ARRAYS:
        g, w = got[k].astype(np.float64), np.asarray(want[k], np.float64)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w), err_msg=k)
        fin = np.isfinite(w)
        if fin.any():
            assert _rel(g[fin], w[fin]) <= 1e-4, (k, g, w)


# ---------------------------------------------------------------------------
# MFU, the timeline, the trace, the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,size", [("GPT2", "124M"), ("GPT2", "355M"),
                                        ("llama3_2", "1B"), ("llama3_1", "8B")])
def test_flops_per_token_matches_jax(model, size):
    jcfg = jcfgs.get_config(model, size)
    tcfg = tcfgs.get_config(model, size)
    for t in (None, 256):
        assert tmfu.flops_per_token(tcfg, t) == jmfu.flops_per_token(jcfg, t)


def test_mfu_arithmetic_and_card_table():
    """The shared denominator math equals JAX's at the same peak; the card
    table gives the dtype's peak (16-bit tensor cores, fp32 CUDA cores);
    off the card the MFU is None and renders 'MFU n/a'."""
    cfg = tcfgs.get_config("GPT2", "124M")
    jcfg = jcfgs.get_config("GPT2", "124M")
    assert tmfu.compute_mfu(1e5, cfg, peak=989e12) == pytest.approx(
        jmfu.compute_mfu(1e5, jcfg, n_devices=1, peak=989e12), rel=1e-15)
    assert tmfu.mfu_from_flops(5e4, 1e9, n_devices=2, peak=1e12) == \
        jmfu.mfu_from_flops(5e4, 1e9, n_devices=2, peak=1e12)
    assert tmfu.compute_mfu(0.0, cfg, peak=1e12) is None
    assert tmfu.compute_mfu(1e5, cfg, device="cpu") is None
    assert tmfu.device_peak_flops("cpu") is None
    assert tmfu.format_mfu(None) == "MFU n/a" and tmfu.format_mfu(0.414) == "41.4% MFU"
    assert tmfu.card_figures("NVIDIA H100 80GB HBM3")[0] == "H100 SXM"
    assert tmfu.card_figures("NVIDIA H100 NVL")[0] == "H100 NVL"
    assert tmfu.card_figures("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert tmfu.card_figures("cpu") is None
    assert tmfu.DEVICE_SPECS["H100 SXM"]["peak16"] == 989e12


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_timeline_spans_accumulate_and_drain(impl):
    """JAX tests/test_obs.py: spans sum into the window, step spans count
    steps and dispatch time, drain resets."""
    tl = (ttimeline if impl == "port" else jtimeline).StepTimeline()
    with tl.span("data_wait"):
        time.sleep(0.01)
    with tl.step_span(1):
        pass
    with tl.step_span(2):
        pass
    with tl.span("eval"):
        time.sleep(0.01)
    win = tl.drain()
    assert win["data_wait"] >= 0.01 and win["eval"] >= 0.01
    assert win["steps"] == 2 and "dispatch" in win
    assert tl.drain() == {"steps": 0}


def test_window_stats_match_jax_and_exclude_non_step_time():
    window = {"data_wait": 0.1, "dispatch": 0.2, "host_fetch": 0.1,
              "eval": 2.0, "sample": 1.0, "checkpoint": 1.0, "steps": 4}
    got = ttimeline.window_stats(window, elapsed=6.0, tokens=8000)
    assert got == jtimeline.window_stats(window, elapsed=6.0, tokens=8000)
    assert got["tok_s"] == pytest.approx(4000.0)
    assert got["step_time_s"] == pytest.approx(0.5)
    assert ttimeline.NON_STEP_SEGMENTS == jtimeline.NON_STEP_SEGMENTS


def test_trainer_throughput_excludes_sample_and_checkpoint_time(tmp_path, monkeypatch):
    """JAX tests/test_obs.py: with a sampler that sleeps 0.3 s every 2
    steps and a checkpoint every 4, the windows' tok/s tracks training
    time, not wall time; the timeline booked the sleeps as ``sample``."""
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.training.trainer import Trainer

    monkeypatch.setattr(Trainer, "generate_and_print_sample",
                        lambda self, *a, **kw: time.sleep(0.3))
    t0 = time.perf_counter()
    t = tmain.run(_cli_flags(tmp_path, "--device", "cpu", "--output_dir",
                             str(tmp_path / "out"), "--print_sample_iter", "2",
                             "--save_ckpt_freq", "4", "--log_every", "2"))
    wall = time.perf_counter() - t0
    assert t.global_step >= 8
    naive = t.tokens_seen / wall
    assert np.mean(t.throughput_tokens_per_s) > 2 * naive
    assert t.step_seconds_total < wall - 0.3 * (t.global_step // 2)


def test_event_registry_matches_jax():
    """Every kind the port registers has the JAX registry's field sets; the
    trace tables agree (the port's incident kinds are JAX's that it emits)."""
    for name, spec in tschema.EVENTS.items():
        j = jschema.EVENTS[name]
        assert (spec.required, spec.optional, spec.open_fields) == \
            (j.required, j.optional, j.open_fields), name
    assert tschema.TRAIN_SEGMENTS == jschema.TRAIN_SEGMENTS
    assert tschema.TICK_PHASES == jschema.TICK_PHASES
    assert set(tschema.INCIDENT_EVENTS) <= set(jschema.INCIDENT_EVENTS)
    for kind in ("watchdog_halt", "preemption_signal", "preemption_stop",
                 "checkpoint_save", "checkpoint_restore", "checkpoint_fallback",
                 "checkpoint_gc", "ckpt_async_save", "memory_snapshot",
                 "memory_drift", "run_complete", "prefix_evict", "adapter_load",
                 "adapter_evict"):
        assert kind in tschema.EVENTS, kind


def _fixture_rows():
    """A JSONL mix of every row the exporter renders: a header, trainer
    cadence rows, engine tick rows, a request span, events."""
    t0 = 1_700_000_000.0
    rows = [{"type": "header", "time": t0, "schema_version": 13}]
    for i in range(1, 4):
        rows.append({"type": "metrics", "time": t0 + 2 * i, "step": 5 * i,
                     "tok_s": 1000.0 + i, "data_wait_s": 0.01 * i,
                     "dispatch_s": 0.2, "host_fetch_s": 0.5, "eval_s": 0.0,
                     "steps_in_window": 5})
        rows.append({"type": "event", "time": t0 + 2 * i + 0.1,
                     "event": "memory_snapshot", "source": "trainer",
                     "components": {"model_params": 100 * i, "host_rss": 7},
                     "capacity_bytes": 1000, "headroom_bytes": 900 - i})
    rows.append({"type": "metrics", "time": t0 + 9, "step": 32,
                 "tick_total_s": 0.4, "tick_admit_s": 0.1, "tick_prefill_s": 0.2,
                 "tick_host_fetch_s": 0.1, "ticks_in_window": 32,
                 "slot_occupancy": 3, "queue_depth": 1})
    rows.append({"type": "span", "time": t0 + 10, "name": "request",
                 "cat": "request", "t0": t0 + 8.5, "dur_s": 1.2, "request_id": 4,
                 "children": [{"name": "queued", "t0": t0 + 8.5, "dur_s": 0.2},
                              {"name": "decode", "t0": t0 + 8.7, "dur_s": 1.0}]})
    for kind, extra in (("request_done", {"request_id": 4}),
                        ("watchdog_halt", {"reason": "spike"}),
                        ("stall", {"elapsed_s": 3.0}),
                        ("checkpoint_save", {"path": "x"})):
        rows.append({"type": "event", "time": t0 + 11, "event": kind, **extra})
    return rows


def test_trace_export_matches_jax(tmp_path):
    """The same JSONL through both packages' exporters: equal trace events
    and counts (the metadata's source names the package), and the CLI."""
    path = tmp_path / "m.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _fixture_rows())
                    + "{torn row\n")
    got = ttrace.chrome_trace(ttrace.load_jsonl(str(path)))
    want = jtrace.chrome_trace(jtrace.load_jsonl(str(path)))
    assert got["traceEvents"] == want["traceEvents"]
    gm, wm = dict(got["metadata"]), dict(want["metadata"])
    assert gm.pop("source") != wm.pop("source") and gm == wm
    assert gm["n_train_windows"] == 3 and gm["n_tick_windows"] == 1
    out = tmp_path / "t.json"
    res = subprocess.run([sys.executable, "-m", "building_llm_from_scratch_tpu_torch.obs.trace",
                          str(path), "-o", str(out)], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0 and "3 train windows" in res.stdout, res.stderr
    assert json.loads(out.read_text())["traceEvents"] == want["traceEvents"]


@pytest.fixture()
def sink(tmp_path):
    path = str(tmp_path / "events.jsonl")
    tmetrics.configure_metrics(path, run_metadata={"test": True})
    yield path
    tmetrics.configure_metrics(None)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_watchdog_halt_names_the_offending_layer(sink):
    """JAX tests/test_obs.py: the halt event and message name the layer
    group of the context; a failing provider or a colliding key does not
    mask the halt; the events validate under the JAX registry."""
    from building_llm_from_scratch_tpu_torch.training.resilience import (
        LossWatchdog,
        TrainingDivergedError,
    )

    wd = LossWatchdog(context_fn=lambda: {
        "first_nonfinite_group": "block_01",
        "top_grad_norm_groups": [{"group": "block_01", "grad_norm": 12.5}]})
    with pytest.raises(TrainingDivergedError, match="block_01"):
        wd.observe(7, float("nan"))
    with pytest.raises(TrainingDivergedError):
        LossWatchdog(context_fn=lambda: 1 / 0).observe(8, float("inf"))
    with pytest.raises(TrainingDivergedError):
        LossWatchdog(context_fn=lambda: {"reason": "shadow", "step": 0,
                                         "first_nonfinite_group": "head"}
                     ).observe(9, float("nan"))
    halts = [r for r in _rows(sink) if r.get("event") == "watchdog_halt"]
    assert halts[0]["first_nonfinite_group"] == "block_01" and halts[0]["step"] == 7
    assert halts[0]["top_grad_norm_groups"][0]["group"] == "block_01"
    assert halts[-1]["reason"] == "non_finite"
    for r in halts:
        fields = {k: v for k, v in r.items() if k not in ("type", "time", "event")}
        assert jschema.validate_event("watchdog_halt", fields) == []


def test_serving_registry_and_store_events_validate(sink, tmp_path):
    """The prefix store's LRU eviction emits ``prefix_evict``, the adapter
    registry ``adapter_load`` / ``adapter_evict``: each validates under the
    JAX registry; the ledger hooks attribute the store's bytes by namespace
    and report pinned entries."""
    from building_llm_from_scratch_tpu_torch.models.lora import (
        init_lora_params,
        save_adapter,
    )
    from building_llm_from_scratch_tpu_torch.serving.adapters import (
        AdapterRegistry,
    )
    from building_llm_from_scratch_tpu_torch.serving.kvcache import PrefixStore

    store = PrefixStore("fp", chunk_tokens=4, budget_bytes=2 * 1024, pane_tokens=64)
    ids = [np.arange(i, i + 8, dtype=np.int32) for i in range(3)]
    for i, tag in enumerate(("base", "a", "a")):
        assert store.insert(ids[i], tag, {"k": torch.zeros(256)})
    assert store.bytes_by_tag() == {"a": 2048}
    span, entry = store.match(np.concatenate([ids[2], [1]]), "a")
    assert store.pinned_bytes() == (1024, [entry.key])
    store.release(entry)
    assert store.pinned_bytes() == (0, [])
    _, tcfg = small_configs("llama")
    lora = init_lora_params(tcfg, torch.Generator().manual_seed(0), rank=2)
    path = str(tmp_path / "a.npz")
    save_adapter(path, lora, rank=2, alpha=4.0, cfg=tcfg)
    reg = AdapterRegistry(tcfg, capacity=2, max_rank=4, device="cpu")
    reg.load("a", path)
    reg.evict("a")
    rows = [r for r in _rows(sink) if r["type"] == "event"]
    kinds = [r["event"] for r in rows]
    assert kinds.count("prefix_evict") == 1 and "adapter_load" in kinds \
        and "adapter_evict" in kinds
    ev = rows[kinds.index("prefix_evict")]
    assert ev["span_tokens"] == 8 and ev["entries_left"] == 2
    for r in rows:
        fields = {k: v for k, v in r.items() if k not in ("type", "time", "event")}
        assert jschema.validate_event(r["event"], fields) == [], r


def test_memory_ledger_trainer_half():
    """``pytree_nbytes`` sums tensors and arrays; ``legacy_row`` carries the
    host RSS (and no device keys on the CPU); a probe's violation is a
    ``memory_drift`` event; ``count_params`` equals the JAX count."""
    from building_llm_from_scratch_tpu.utils.memory import count_params as jcount
    from building_llm_from_scratch_tpu_torch.obs.memory import (
        MemoryLedger,
        pytree_nbytes,
    )
    from building_llm_from_scratch_tpu_torch.utils.memory import (
        count_params,
        device_memory_stats,
        estimate_memory_static,
        host_rss_bytes,
    )

    tree = {"a": torch.zeros(3, 4), "b": [np.zeros(5, np.float16), {"c": torch.zeros(2)}]}
    assert pytree_nbytes(tree) == 48 + 10 + 8
    events = []
    led = MemoryLedger(emit=lambda kind, **f: events.append((kind, f)),
                       source="trainer", device="cpu")
    led.register("model_params", lambda: 100)
    led.track_host_rss()
    led.register_probe("probe", lambda: {"reason": "pinned_orphan", "pinned_bytes": 4})
    led.observe(3)
    row = led.legacy_row()
    assert set(row) == {"host_rss_bytes"} and row["host_rss_bytes"] > 0
    kinds = [k for k, _ in events]
    assert kinds == ["memory_drift", "memory_snapshot"]
    assert events[1][1]["host_bytes"] == row["host_rss_bytes"]
    for kind, f in events:
        assert jschema.validate_event(kind, f) == []
    jcfg, tcfg = small_configs("llama")
    params, np_params = jax_params(jcfg)
    model = params_from_jax(np_params, tcfg, "cpu")
    assert count_params(model.stacked) == jcount(params)
    assert estimate_memory_static(10, "bf16") == pytest.approx(80 / 1024**3)
    assert device_memory_stats("cpu") == {} and host_rss_bytes() > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TEXT = ("Every effort moves you closer to mastery. " * 12
        + "A quick brown fox jumps over the lazy dog. " * 6)

def _xla_key(key: str) -> bool:
    """JAX metrics-row keys the port leaves out by design: the XLA compile
    telemetry's HLO MFU and its gauges (``obs/compile.py``: compile seconds,
    the HLO memory analysis, the recompile count)."""
    return key in ("mfu_hlo", "mfu_delta", "compile_seconds_total",
                   "recompile_count") or key.startswith("hlo_")


def _cli_flags(tmp_path, *extra):
    d = tmp_path / "data"
    d.mkdir(exist_ok=True)
    (d / "corpus.txt").write_text(TEXT)
    return ["--model", "llama3_2", "--num_params", "1B", "--debug",
            "--byte_tokenizer", "--data_type", "fp32", "--n_epochs", "1",
            "--batch_size", "4", "--eval_freq", "4", "--print_sample_iter", "1000",
            "--warmup_steps", "2", "--data_dir", str(d), *extra]


def _keys(rows, kind):
    """Row keys of a type, the sink's own event counters left out."""
    return [{k for k in r if not k.startswith("event:")} for r in rows
            if r["type"] == kind]


def test_both_clis_write_the_same_telemetry(tmp_path, monkeypatch):
    """``--mode train --metrics_jsonl --log_every 2`` through both CLIs on
    the same data: the same row types and, row for row, the same metrics
    and health keys (the JAX HLO-MFU keys and the sinks' event counters
    aside); the health rows' groups equal; every port event validates
    under JAX ``validate_event``; ``scripts/summarize_metrics.py`` renders
    the port's file."""
    from building_llm_from_scratch_tpu import main as jmain
    from building_llm_from_scratch_tpu_torch import main as tmain

    monkeypatch.setattr(jmain, "plot_losses", lambda *a, **kw: None)
    flags = _cli_flags(tmp_path, "--log_every", "2")
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jmain.run(flags + ["--output_dir", str(tmp_path / "jout"), "--save_ckpt_freq",
                       "1000", "--metrics_jsonl", str(jpath)])
    tmain.run(flags + ["--output_dir", str(tmp_path / "tout"), "--device", "cpu",
                       "--metrics_jsonl", str(tpath)])
    tmetrics.configure_metrics(None)
    jrows, trows = _rows(jpath), _rows(tpath)
    assert {r["type"] for r in trows} == {r["type"] for r in jrows} \
        == {"header", "metrics", "health", "event"}
    jm, tm = _keys(jrows, "metrics"), _keys(trows, "metrics")
    assert len(tm) == len(jm) >= 4
    for a, b in zip(tm, jm):
        b = {k for k in b if not _xla_key(k)}
        assert a == b, sorted(a ^ b)
    assert _keys(trows, "health") == _keys(jrows, "health")
    jh = [r["groups"] for r in jrows if r["type"] == "health"]
    assert [r["groups"] for r in trows if r["type"] == "health"] == jh
    tev = [r for r in trows if r["type"] == "event"]
    assert {"memory_snapshot", "checkpoint_save", "run_complete"} <= \
        {r["event"] for r in tev}
    for r in tev:
        fields = {k: v for k, v in r.items() if k not in ("type", "time", "event")}
        assert jschema.validate_event(r["event"], fields) == [], r
    metrics = [r for r in trows if r["type"] == "metrics"]
    assert all(r["mfu"] is None and r["steps_in_window"] == 2 for r in metrics)
    assert [r["step"] for r in metrics] == [r["step"] for r in jrows
                                            if r["type"] == "metrics"]
    res = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                       "summarize_metrics.py"),
                          str(tpath)], cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0 and "step" in res.stdout.lower(), res.stderr[-2000:]


def test_cli_profile_writes_a_trace_with_the_named_regions(tmp_path):
    """``--profile --profile_steps 2`` on the CPU: a Chrome trace under
    <output_dir>/profile holding the timeline's spans and the step's
    forward / backward / optimizer regions, one ``train step`` region per
    profiled step."""
    from building_llm_from_scratch_tpu_torch import main as tmain

    out = tmp_path / "out"
    t = tmain.run(_cli_flags(tmp_path, "--device", "cpu", "--output_dir", str(out),
                             "--profile", "--profile_steps", "2"))
    assert t.profile_trace == str(out / "profile" / "trace_rank0.json")
    events = json.loads((out / "profile" / "trace_rank0.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"data_wait", "dispatch", "forward", "backward", "optimizer"} <= names
    assert sorted(n for n in names if str(n).startswith("train step")) == [
        "train step 1", "train step 2"]


def test_cli_stall_timeout_fires_on_a_blocked_step(tmp_path, monkeypatch):
    """``--stall_timeout`` in train mode: a train step that blocks past the
    threshold makes the flight recorder emit ``stall`` (the step is
    released once it has; later cadence pauses past 0.3 s may fire again);
    the run then finishes."""
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.obs import stall as tstall
    from building_llm_from_scratch_tpu_torch.training.trainer import Trainer

    fired = threading.Event()
    orig_init = tstall.StallDetector.__init__

    def fast(self, timeout, **kw):
        orig_init(self, timeout, poll_interval=0.02, first_grace=1.0,
                  on_stall=lambda *a: fired.set())
    monkeypatch.setattr(tstall.StallDetector, "__init__", fast)
    orig_fin = Trainer._finalize_steps

    def blocking(self):
        orig_fin(self)
        step = self.train_step

        def train_step(state, batch):
            if self.global_step == 2:
                assert fired.wait(30), "no stall fired"
            return step(state, batch)
        self.train_step = train_step
    monkeypatch.setattr(Trainer, "_finalize_steps", blocking)
    path = tmp_path / "m.jsonl"
    t = tmain.run(_cli_flags(tmp_path, "--device", "cpu", "--output_dir",
                             str(tmp_path / "out"), "--stall_timeout", "0.3",
                             "--metrics_jsonl", str(path)))
    tmetrics.configure_metrics(None)
    assert fired.is_set() and t.global_step >= 8
    stalls = [r for r in _rows(path) if r.get("event") == "stall"]
    assert stalls and stalls[0]["threshold_s"] == pytest.approx(0.3)


def test_cli_takes_the_telemetry_flags(tmp_path, capsys):
    """The JAX CLI's telemetry flags parse in train mode with the JAX
    defaults and checks; ``--compile_cache_dir`` is refused by name as
    XLA's."""
    from building_llm_from_scratch_tpu_torch.args import get_args

    base = ["--mode", "train", "--data_dir", str(tmp_path)]
    a = get_args(base + ["--metrics_jsonl", "m.jsonl", "--log_every", "5",
                         "--stall_timeout", "30", "--profile", "--profile_steps",
                         "3", "--warnings"])
    assert (a.metrics_jsonl, a.log_every, a.stall_timeout, a.profile,
            a.profile_steps, a.warnings) == ("m.jsonl", 5, 30.0, True, 3, True)
    d = get_args(base)
    assert (d.log_every, d.profile, d.profile_steps, d.warnings) == (0, False, 10, False)
    with pytest.raises(ValueError, match="log_every"):
        get_args(base + ["--log_every", "-1"])
    with pytest.raises(SystemExit):
        get_args(base + ["--compile_cache_dir", "c"])
    err = capsys.readouterr().err
    assert "--compile_cache_dir" in err and "XLA" in err and "item 10" not in err
