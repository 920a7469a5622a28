"""JAX references for the port's tensor-, sequence- and pipeline-parallel
tests (``test_torch_tensor_parallel.py``, ``test_torch_pipeline.py``),
computed in a process of their own:

    python tests/torch_jax_refs.py SPEC.json OUT.npz

The spec lists jobs; each writes its arrays under ``<label>/...`` in
OUT.npz. A JAX sp training compile that follows another in one process can
abort inside XLA (``test_ring_attention::test_sp_with_fsdp_params``), so
the test process never compiles one itself: it reads this file's output.

Jobs:
  ``steps``  the JAX GSPMD ``make_train_step`` (or, ``explicit``, the
             ``make_sharded_train_step``) on ``build_mesh_plan(mode, tp=,
             sp=)`` over the first ``n_dev`` CPU devices, from the params
             and global batches of the spec's ``.npz`` files: per-step
             losses, the final trainable leaves and the first step's
             health bundle (``health/<array>``);
  ``save``   the initial train state placed on the job's plan, written
             by the JAX ``save_checkpoint`` (the reference layout);
  ``ring``   ``ring_causal_attention`` at ``sp`` (data 1) on the spec's
             q, k, v and the upstream gradient ``do``: the output and the
             gradients of sum(out * do);
  ``cli``    the JAX CLI (``main.run``) on the job's ``flags`` over every
             CPU device: its train and validation losses, tokens seen,
             global step and the final export's leaves (``params/...``);
  ``pp``     ``make_pp_train_step`` on ``make_pp_mesh(pp, devices[:n_dev],
             tp)`` with ``micro`` microbatches (and a LoRA adapter file):
             per-step losses, the final trainable leaves, the first
             step's health bundle, the pp eval loss on the first batch,
             and (``save``) the final state
             written by the JAX ``save_checkpoint``.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from building_llm_from_scratch_tpu import configs as jcfgs  # noqa: E402
from building_llm_from_scratch_tpu.parallel import build_mesh_plan  # noqa: E402
from building_llm_from_scratch_tpu.training import precision as jprec  # noqa: E402
from building_llm_from_scratch_tpu.training.checkpoint import (  # noqa: E402
    load_exported_params,
)
from building_llm_from_scratch_tpu.training.optim import (  # noqa: E402
    build_optimizer,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu.training.train_step import (  # noqa: E402
    init_train_state,
    make_sharded_train_step,
    make_train_step,
)


def _cfg(d: dict):
    d = dict(d)
    if d.get("rope_scaling") is not None:
        d["rope_scaling"] = jcfgs.RopeScaling(**d["rope_scaling"])
    return jcfgs.ModelConfig(**d)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def steps(job: dict) -> dict:
    from building_llm_from_scratch_tpu.models import init_params

    cfg = _cfg(job["cfg"])
    params = load_exported_params(job["params"], init_params(cfg, jax.random.PRNGKey(0)))
    data = np.load(job["batches"])
    sched = warmup_cosine_schedule(*job["sched"])
    opt = build_optimizer(schedule=sched)
    plan = build_mesh_plan(job["mode"], tp=job.get("tp", 1), sp=job.get("sp", 1),
                           devices=jax.devices()[:job["n_dev"]])
    policy = jprec.get_policy(job.get("policy"))
    state = init_train_state(params, opt, jax.random.PRNGKey(0), policy=policy)
    if job.get("explicit"):
        step = make_sharded_train_step(cfg, opt, plan, lr_schedule=sched, policy=policy,
                                       sp_mesh=plan.sp_mesh)
    else:
        step = make_train_step(cfg, opt, lr_schedule=sched, policy=policy,
                               sp_mesh=plan.sp_mesh)
    losses, health = [], {}
    for i in range(job["steps"]):
        batch = {"inputs": data["inputs"][i].astype(np.int32),
                 "targets": data["targets"][i].astype(np.int32),
                 "weights": np.ones(data["targets"][i].shape, np.float32)}
        state, m = step(plan.shard_state(state), plan.shard_batch(batch))
        losses.append(float(m["loss"]))
        health = health or _health(m)
    out = {f"trainable/{k}": v for k, v in
           _flat(jax.device_get(state["trainable"])).items()}
    out["losses"] = np.asarray(losses, np.float64)
    out.update(health)
    return out


def _health(metrics) -> dict:
    """The step's health bundle (the first step's, as the callers keep
    it) as ``health/<array>``."""
    return {f"health/{k}": np.asarray(v)
            for k, v in jax.device_get(metrics["health"]).items()}


def ring(job: dict) -> dict:
    from building_llm_from_scratch_tpu.ops.ring_attention import ring_causal_attention

    d = np.load(job["qkv"])
    q, k, v, do = (jnp.asarray(d[n]) for n in ("q", "k", "v", "do"))
    plan = build_mesh_plan("dp", sp=job["sp"], devices=jax.devices()[:job["sp"]])

    def loss(q, k, v):
        out = ring_causal_attention(q, k, v, plan.mesh)
        return jnp.sum(out.astype(jnp.float32) * do), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(q, k, v)
    return {"out": np.asarray(out, np.float32),
            **{f"d{n}": np.asarray(g, np.float32) for n, g in zip("qkv", grads)}}


def save(job: dict) -> dict:
    """The initial train state placed on the job's plan and saved with
    the JAX ``save_checkpoint`` into ``job["out"]`` (its manifest is the
    reference layout)."""
    from building_llm_from_scratch_tpu.models import init_params
    from building_llm_from_scratch_tpu.training.checkpoint import save_checkpoint

    cfg = _cfg(job["cfg"])
    params = load_exported_params(job["params"], init_params(cfg, jax.random.PRNGKey(0)))
    opt = build_optimizer(schedule=warmup_cosine_schedule(*job["sched"]))
    plan = build_mesh_plan(job["mode"], tp=job.get("tp", 1), sp=job.get("sp", 1),
                           devices=jax.devices()[:job["n_dev"]])
    state = plan.shard_state(init_train_state(params, opt, jax.random.PRNGKey(0)))
    save_checkpoint(job["out"], state, extra_metadata={"global_step": 0})
    return {}


def cli(job: dict) -> dict:
    from building_llm_from_scratch_tpu import main as jmain
    from building_llm_from_scratch_tpu.models import init_params

    jmain.plot_losses = lambda *a, **kw: None
    t = jmain.run(job["flags"])
    params = load_exported_params(job["export"], init_params(t.cfg, jax.random.PRNGKey(0)))
    out = {f"params/{k}": v for k, v in _flat(jax.device_get(params)).items()}
    out.update(train_losses=np.asarray(t.train_losses, np.float64),
               val_losses=np.asarray(t.val_losses, np.float64),
               tokens_seen=np.asarray(t.tokens_seen), global_step=np.asarray(t.global_step))
    return out


def pp(job: dict) -> dict:
    from building_llm_from_scratch_tpu.models import init_params
    from building_llm_from_scratch_tpu.models.lora import load_adapter
    from building_llm_from_scratch_tpu.parallel.pipeline import (
        PipelinePlan,
        make_pp_eval_step,
        make_pp_mesh,
        make_pp_train_step,
    )
    from building_llm_from_scratch_tpu.training.checkpoint import save_checkpoint

    cfg = _cfg(job["cfg"])
    params = load_exported_params(job["params"], init_params(cfg, jax.random.PRNGKey(0)))
    data = np.load(job["batches"])
    sched = warmup_cosine_schedule(*job["sched"])
    opt = build_optimizer(schedule=sched)
    mesh = make_pp_mesh(job["pp"], jax.devices()[:job["n_dev"]], tp=job.get("tp", 1))
    plan = PipelinePlan(mesh, n_micro=job["micro"])
    kw = {}
    if job.get("lora"):
        tree, meta = load_adapter(job["lora"])
        state = init_train_state(tree, opt, jax.random.PRNGKey(0), frozen=params)
        kw = dict(lora_alpha=float(meta["alpha"]), lora_rank=int(meta["rank"]))
    else:
        state = init_train_state(params, opt, jax.random.PRNGKey(0))
    step = make_pp_train_step(cfg, opt, mesh, n_micro=job["micro"], lr_schedule=sched, **kw)
    batches = [{"inputs": data["inputs"][i].astype(np.int32),
                "targets": data["targets"][i].astype(np.int32)}
               for i in range(job["steps"])]
    losses, health = [], {}
    for batch in batches:
        state, m = step(plan.shard_state(state), plan.shard_batch(batch))
        losses.append(float(m["loss"]))
        health = health or _health(m)
    state = plan.shard_state(state)
    ev = make_pp_eval_step(cfg, mesh, n_micro=job["micro"], **kw)(
        state, plan.shard_batch(batches[0]))
    if job.get("save"):
        save_checkpoint(job["save"], state, extra_metadata={"global_step": job["steps"]})
    out = {f"trainable/{k}": v for k, v in
           _flat(jax.device_get(state["trainable"])).items()}
    out.update(losses=np.asarray(losses, np.float64), eval=np.asarray(float(ev)))
    out.update(health)
    return out


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    out = {}
    for job in spec["jobs"]:
        res = {"steps": steps, "ring": ring, "save": save, "cli": cli,
               "pp": pp}[job["kind"]](job)
        out.update({f"{job['label']}/{k}": v for k, v in res.items()})
    np.savez(sys.argv[2], **out)


if __name__ == "__main__":
    main()
