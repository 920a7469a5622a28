"""One rank of the port's multi-rank CPU tests (``test_torch_distributed.py``).

    python tests/torch_dist_worker.py SPEC.json RANK

runs one rank of a gloo group (``file://`` rendezvous named in the spec),
on the CPU or the spec's ``device`` (two ranks on one card: gloo stages
through the host), and writes what it measured to ``<out>/rank<RANK>.pt``;
``launch`` starts the ranks and collects their results. It
imports torch and the port only, never JAX or the JAX package (the
isolation test checks its modules). Scenarios:

  ``steps``  the sharded train step under each (mode, policy) of the spec
             on the rank's rows (``[rank::world]``) of the spec's global
             batches, from the spec's initial weights (an export ``.npz``)
             and optional LoRA adapter; per-step metrics, the collective
             counters, the rank's moment bytes, what it holds between
             steps and the whole final parameters. ``control``: each rank steps alone on its rows
             with the single-device step (no gradient reduce). ``overflow``
             poisons one rank's reduced gradient shard at one step;
             ``contiguous_rows`` gives rank r the r-th contiguous block of
             each global batch (a JAX mesh's rows) instead of the loader's
             ``[rank::world]``; ``all_rows`` every row (one rank's run);
             ``skip_reduce`` leaves the row-parallel outputs unreduced (the
             tp control); ``census`` keeps, for each block boundary of
             fsdp's per-layer gathers, the layers whose weights it held.
             ``save``/``load``: a checkpoint of the final state written,
             or a state restored from one and dumped whole; ``resume``: a
             run restored from a checkpoint that steps on from its step.
             Mode ``pp`` is the pipelined step on a (data, stage, model)
             mesh of ``pp`` stages, ``micro`` microbatches and ``tp``
             (every rank on the whole global batch; ``dropout_stages``:
             the masks' stage count), ``pp_one`` one stage in each
             process alone; ``drop_hop`` zeroes every forward hop's
             activation and ``skip_stage_reduce`` sums the replicated
             leaves over the data line alone (the pp controls);
             ``deterministic`` turns on torch's deterministic algorithms and
             ``save_all`` the save-all remat mode.
  ``ring``   ring attention on a (data, seq) mesh: each rank's block of the
             output and of the gradients (``run_ring``).
  ``parts``  several of the above in one group, one after the other.
  ``cli``    ``main.run`` under torchrun's environment (``WORLD_SIZE``,
             ``RANK``, ``BLLM_INIT_METHOD``) for each argv of the spec,
             each in a group of its own; ``sigterm`` sends SIGTERM to one
             rank after a given step of one run. In a ``parts`` spec the
             ``cli`` parts run last, after the parts' group has closed.
"""

from __future__ import annotations

import json
import os
import signal
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from building_llm_from_scratch_tpu_torch import configs as tcfgs  # noqa: E402
from building_llm_from_scratch_tpu_torch.parallel import (  # noqa: E402
    collectives as coll,
)
from building_llm_from_scratch_tpu_torch.parallel import mesh  # noqa: E402
from building_llm_from_scratch_tpu_torch.parallel import pipeline  # noqa: E402
from building_llm_from_scratch_tpu_torch.parallel.sharding import (  # noqa: E402
    build_mesh_plan,
)
from building_llm_from_scratch_tpu_torch.training import optim as topt  # noqa: E402
from building_llm_from_scratch_tpu_torch.training import precision  # noqa: E402
from building_llm_from_scratch_tpu_torch.training import train_step as tts  # noqa: E402
from building_llm_from_scratch_tpu_torch.training.checkpoint import (  # noqa: E402
    load_exported_params,
    save_checkpoint,
)

torch.set_num_threads(1)


def _cfg(d: dict) -> tcfgs.ModelConfig:
    d = dict(d)
    if d.get("rope_scaling") is not None:
        d["rope_scaling"] = tcfgs.RopeScaling(**d["rope_scaling"])
    return tcfgs.ModelConfig(**d)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy().copy()


def _lora(spec: dict, device):
    from building_llm_from_scratch_tpu_torch.models.lora import load_adapter

    from building_llm_from_scratch_tpu_torch.models.lora import unflatten_lora
    from building_llm_from_scratch_tpu_torch.models.lora import flatten_lora

    lora, _ = load_adapter(spec["path"])
    return unflatten_lora({k: v.to(device) for k, v in flatten_lora(lora).items()})


def _state(spec: dict, cfg, mode, policy_name, rank: int, world: int,
           opts: dict):
    """(plan or None, state, step fn, eval fn) of one run (``opts``: the
    run's ``tp`` and ``sp`` sizes)."""
    policy = precision.get_policy(policy_name)
    model = load_exported_params(spec["params"], cfg, spec.get("device", "cpu"))
    opt = topt.AdamW(topt.warmup_cosine_schedule(*spec["sched"]))
    lspec = spec.get("lora")
    kw = dict(policy=policy)
    if mode == "pp":
        plan = pipeline.build_pp_plan(opts["pp"], n_micro=opts["micro"],
                                      tp=opts.get("tp", 1))
    elif mode == "pp_one":
        plan = pipeline.PipelinePlan(mesh=pipeline.make_pp_mesh(1, world_size=1),
                                     n_micro=opts["micro"])
    else:
        plan = None if mode == "control" else build_mesh_plan(
            mode, tp=opts.get("tp", 1), sp=opts.get("sp", 1))
    if lspec:
        kw.update(lora_alpha=lspec["alpha"], lora_rank=lspec["rank"])
        state = tts.init_train_state(_lora(lspec, model.device), opt,
                                     seed=spec["seed"],
                                     frozen=model, policy=policy, plan=plan)
    else:
        state = tts.init_train_state(model, opt, seed=spec["seed"],
                                     policy=policy, plan=plan)
    accum = spec.get("grad_accum", 1)
    if mode in ("pp", "pp_one"):
        step = tts.make_pp_train_step(cfg, opt, plan,
                                      dropout_stages=opts.get("dropout_stages"), **kw)
        return plan, state, step, tts.make_pp_eval_step(cfg, plan, **kw)
    if plan is None:
        step = tts.make_train_step(cfg, opt, grad_accum=accum, **kw)
    else:
        step = tts.make_sharded_train_step(cfg, opt, plan, grad_accum=accum, **kw)
    return plan, state, step, tts.make_eval_step(cfg, plan=plan, **kw)


def _whole(state) -> dict:
    """The state's trainable leaves and moments, whole (gathered over the
    data axis, then the model axis; under pp over the model axis, then the
    stage axis)."""
    whole = tts.gather_whole(state)
    if state.stage_axes:
        full = state.whole_lora if state.lora is not None else whole.stacked
        out = {f"trainable/{k}": _np(v) for k, v in full.items()}
        for name, moments in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
            out.update({f"{name}/{k}": _np(tts.gather_slice(state, k, m))
                        for k, m in moments.items()})
        if state.lora is not None:
            out.update({f"frozen/{k}": _np(v) for k, v in whole.stacked.items()})
        return out
    full = state.full if state.lora is not None else whole.stacked
    out = {f"trainable/{k}": _np(v) for k, v in full.items()}
    plan = state.plan
    for name, moments in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        for k, m in moments.items():
            m = coll.gather_full(m, state.opt_axes.get(k), group=plan.group("data"))
            m = coll.gather_full(m, state.tp_axes.get(k), group=plan.group("model"))
            out[f"{name}/{k}"] = _np(m)
    if state.lora is not None:
        out.update({f"frozen/{k}": _np(v) for k, v in state.model.stacked.items()})
    return out


def _held(state) -> dict:
    """What the rank holds between steps: the sharded leaves, those of them
    whose working copy and gradient buffer hold no memory, and the bytes of
    every distinct storage of the state's tensors."""
    tensors = [*state.full.values(), *state.grads.values(), *state.params.values(),
               *state.opt_state.mu.values(), *state.opt_state.nu.values()]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}
    sharded = sorted(k for k, a in state.param_axes.items() if a is not None)
    freed = [k for k in sharded if state.full[k].untyped_storage().nbytes() == 0
             and state.grads[k].untyped_storage().nbytes() == 0]
    return dict(sharded=sharded, freed=freed,
                resident_bytes=sum(n for p, n in storages.items() if p))


def _batch(data, i: int, rows: slice, device) -> dict:
    batch = {"inputs": torch.from_numpy(data["inputs"][i][rows]).long(),
             "targets": torch.from_numpy(data["targets"][i][rows]).long()}
    if "weights" in data:
        batch["weights"] = torch.from_numpy(data["weights"][i][rows])
    return {k: v.to(device) for k, v in batch.items()}


def run_steps(spec: dict, rank: int, world: int) -> dict:
    cfg = _cfg(spec["cfg"])
    data = np.load(spec["batches"])
    results = {}
    for label, mode, policy_name, *opts in spec["runs"]:
        opts = dict(spec, **(opts[0] if opts else {}))
        coll.reset_counters()
        # B4 asked for (BLLM_XENT_PALLAS=1) while the step is built
        xent_env = os.environ.get("BLLM_XENT_PALLAS")
        os.environ["BLLM_XENT_PALLAS"] = "1" if opts.get("xent_kernel") else "0"
        plan, state, step, eval_step = _state(spec, cfg, mode, policy_name,
                                              rank, world, opts)
        if xent_env is None:
            del os.environ["BLLM_XENT_PALLAS"]
        else:
            os.environ["BLLM_XENT_PALLAS"] = xent_env
        if opts.get("deterministic"):
            torch.use_deterministic_algorithms(True)
        if spec.get("load"):
            tts.restore_train_state(state, spec["load"])
            results[label] = dict(whole=_whole(state), step=state.step,
                                  count=state.opt_state.count)
            continue
        overflow = spec.get("overflow")
        if overflow and plan is not None:
            comm_reduce = tts._Collectives.reduce

            def reduce(self, st, grads, _orig=comm_reduce):
                out = _orig(self, st, grads)
                if st.step == overflow["step"] and rank == overflow["rank"]:
                    k = next(k for k, a in st.param_axes.items() if a is not None)
                    out[k].view(-1)[0] = float("inf")
                return out
            tts._Collectives.reduce = reduce
        dev = state.model.device
        start = 0
        if opts.get("resume"):
            tts.restore_train_state(state, opts["resume"])
            start = state.step
        # the data rank's rows (its seq and model ranks share them)
        d, nd = (plan.data_rank, plan.n_data) if plan is not None else (rank, world)
        if opts.get("all_rows") or mode in ("pp", "pp_one"):
            d, nd = 0, 1
        rows = slice(d, None, nd)
        if opts.get("skip_reduce"):
            # the control: the row-parallel outputs left unreduced
            from building_llm_from_scratch_tpu_torch.parallel import tensor as ptensor

            saved_reduce = ptensor.Parallel.reduce_from_model
            ptensor.Parallel.reduce_from_model = lambda self, x: x
        if opts.get("contiguous_rows"):
            # the rows a JAX mesh gives each data index: contiguous
            n = data["inputs"].shape[1] // nd
            rows = slice(d * n, (d + 1) * n)
        if opts.get("drop_hop"):
            hop = pipeline.hop_forward
            pipeline.hop_forward = lambda y, dst: hop(torch.zeros_like(y), dst)
        if opts.get("skip_stage_reduce"):
            tts._PipelineCollectives.REPLICATED = "data"
        if opts.get("save_all"):
            from building_llm_from_scratch_tpu_torch.models import transformer

            transformer._SAVE_ALL = True
        gathers = []
        if opts.get("census"):
            # every per-layer fsdp source of the run's steps, kept to read
            # which layers' weights it held at each block boundary
            init = tts._LayerGather.__init__

            def keep(self, *a, _init=init, **kw):
                _init(self, *a, **kw)
                gathers.append(self)
            tts._LayerGather.__init__ = keep
        if opts.get("no_health_reduce"):
            # the health control: each rank's bundle of its own slices
            from building_llm_from_scratch_tpu_torch.obs import health

            health_init = health.GroupSums.__init__

            def local(self, layout, splits=(), moment_splits=None, reduce=None,
                      _init=health_init):
                _init(self, layout, splits, moment_splits,
                      lambda t, axis: t)
            health.GroupSums.__init__ = local
        metrics = []
        for i in range(start, opts["steps"]):
            batch = _batch(data, i, rows, dev)
            state, m = step(state, batch)
            metrics.append({k: (float(v) if torch.is_tensor(v) else
                                {hk: hv.cpu().numpy() for hk, hv in v.items()}
                                if k == "health" else v)
                            for k, v in m.items()})
        if opts.get("no_health_reduce"):
            health.GroupSums.__init__ = health_init
        if overflow and plan is not None:
            tts._Collectives.reduce = comm_reduce
        if opts.get("skip_reduce"):
            ptensor.Parallel.reduce_from_model = saved_reduce
        if opts.get("census"):
            tts._LayerGather.__init__ = init
        if opts.get("drop_hop"):
            pipeline.hop_forward = hop
        tts._PipelineCollectives.REPLICATED = "data_stage"
        if opts.get("save_all"):
            transformer._SAVE_ALL = False
        held = _held(state)
        ev = None
        if spec.get("eval"):
            ev = float(eval_step(state, _batch(data, 0, rows, dev)))
        moment_bytes = sum(t.numel() * t.element_size()
                           for d in (state.opt_state.mu, state.opt_state.nu)
                           for t in d.values())
        if opts.get("save") and plan is not None:
            save_checkpoint(os.path.join(opts["save"], label),
                            tts.checkpoint_tree(state),
                            {"global_step": state.step},
                            tts.checkpoint_layout(state))
        if opts.get("deterministic"):
            torch.use_deterministic_algorithms(False)
        results[label] = dict(metrics=metrics, counters=coll.counters(),
                              layers_held=[g.held for g in gathers],
                              moment_bytes=moment_bytes, eval=ev, **held,
                              whole=None if mode == "control" else _whole(state),
                              rank_params={k: _np(v) for k, v in state.full.items()})
    return results


def run_cli(spec: dict, rank: int, world: int) -> dict:
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.training import trainer as ttr

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True)
    results = {}
    for i, (label, argv) in enumerate(spec["runs"]):
        os.environ[mesh.INIT_METHOD_ENV] = f"{spec['init']}-{i}"
        kill = spec.get("sigterm")
        orig = ttr.make_sharded_train_step
        if kill and kill["run"] == label and kill["rank"] == rank:
            def make(*a, _orig=orig, **kw):
                step = _orig(*a, **kw)

                def killing(state, batch):
                    out = step(state, batch)
                    if state.step == kill["after_step"]:
                        os.kill(os.getpid(), signal.SIGTERM)
                    return out
                return killing
            ttr.make_sharded_train_step = make
        coll.reset_counters()
        try:
            tr = tmain.run(argv)
        finally:
            ttr.make_sharded_train_step = orig
        results[label] = dict(
            losses=[m["loss"] for m in tr.step_metrics],
            steps=[m["step"] for m in tr.step_metrics],
            train_losses=tr.train_losses, val_losses=tr.val_losses,
            tokens_seen=tr.tokens_seen, global_step=tr.global_step,
            preempted=tr.preempted, samples=tr.samples,
            restored=tr.restored, counters=coll.counters(),
            cursor=tr._cursor,
            moment_bytes=sum(t.numel() * t.element_size()
                             for d in (tr.state.opt_state.mu, tr.state.opt_state.nu)
                             for t in d.values()))
    return results


def run_ring(spec: dict, rank: int, world: int) -> dict:
    """Ring attention on a (data, seq) mesh of ``spec["sp"]`` seq ranks: the
    data rank's rows of the global q, k, v, do (an ``.npz``), this rank's T
    block through ``ring_causal_attention`` (fp32 or the spec's dtype) and
    the gradients of sum(out * do), and whether a second forward repeats
    the first bit for bit (the dropout masks regenerated)."""
    from building_llm_from_scratch_tpu_torch.ops.ring_attention import (
        ring_causal_attention,
    )

    plan = build_mesh_plan("dp", sp=spec["sp"])
    d = np.load(spec["qkv"])
    dtype = getattr(torch, spec.get("dtype", "float32"))
    rows = slice(plan.data_rank, None, plan.n_data)
    T = d["q"].shape[1]
    n = T // plan.n_seq
    cols = slice(plan.seq_rank * n, (plan.seq_rank + 1) * n)
    t = {k: torch.from_numpy(d[k][rows, cols]).to(dtype).requires_grad_(k != "do")
         for k in ("q", "k", "v", "do")}
    kw = dict(group=plan.group("seq"), n=plan.n_seq, rank=plan.seq_rank,
              dropout_rate=spec.get("rate", 0.0), seed=spec.get("seed", 0))
    coll.reset_counters()
    out = ring_causal_attention(t["q"], t["k"], t["v"], **kw)
    (out.float() * t["do"].float()).sum().backward()
    res = dict(out=_np(out), dq=_np(t["q"].grad), dk=_np(t["k"].grad),
               dv=_np(t["v"].grad), rows=[plan.data_rank, plan.n_data],
               cols=[cols.start, cols.stop], counters=coll.counters())
    with torch.no_grad():
        res["repeat_equal"] = torch.equal(
            out, ring_causal_attention(t["q"], t["k"], t["v"], **kw))
    return res


def run_xent(spec: dict, rank: int, world: int) -> dict:
    """The vocab-parallel cross entropy over a model axis of every rank:
    this rank's columns of the spec's fp32 logits, the per-token nll and
    the gradient of its sum against the weights ``w``."""
    from building_llm_from_scratch_tpu_torch.ops.softmax_xent import (
        vocab_parallel_cross_entropy,
    )

    plan = build_mesh_plan("tp", tp=world)
    d = np.load(spec["xent"])
    V = d["logits"].shape[1] // world
    logits = torch.from_numpy(d["logits"][:, rank * V:(rank + 1) * V]).requires_grad_()
    nll = vocab_parallel_cross_entropy(logits, torch.from_numpy(d["targets"]),
                                       rank * V, plan.group("model"))
    (nll * torch.from_numpy(d["w"])).sum().backward()
    return dict(nll=_np(nll), grad=_np(logits.grad))


def launch(spec: dict, world: int, out: str, timeout: float = 120) -> list:
    """Run ``world`` processes of this worker on ``spec`` (written to
    ``out``); their results by rank. A failed rank, or a group that
    outlives ``timeout``, raises ``RuntimeError`` after every process is
    killed."""
    import subprocess

    spec = dict(spec, world=world, out=out,
                init=spec.get("init") or f"file://{out}/rendezvous")
    path = os.path.join(out, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path,
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"the {world}-rank group did not finish in {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} failed:\n{log[-4000:]}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank, world = int(sys.argv[2]), spec["world"]
    if spec["scenario"] == "cli":
        out = run_cli(spec, rank, world)
    else:
        mesh.initialize_distributed(backend="gloo", init_method=spec["init"],
                                    rank=rank, world_size=world,
                                    device=spec.get("device", "cpu"),
                                    timeout_s=120)
        try:
            if spec["scenario"] == "parts":
                # several scenarios in one group, in the same order on every
                # rank (each mesh's subgroups are made once, collectively)
                runs = {"ring": run_ring, "xent": run_xent, "steps": run_steps}
                out = {p["name"]: runs[p["scenario"]](dict(spec, **p), rank, world)
                       for p in spec["parts"] if p["scenario"] != "cli"}
            else:
                out = run_steps(spec, rank, world)
        finally:
            mesh.shutdown_distributed()
        for p in spec.get("parts", ()):
            if p["scenario"] == "cli":
                out[p["name"]] = run_cli(dict(spec, **p), rank, world)
    torch.save(dict(out, modules=sorted(sys.modules)),
               os.path.join(spec["out"], f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
