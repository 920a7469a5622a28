"""The port's parallel tier in one process: the sharding rules against the
JAX ``MeshPlan`` on every leaf of GPT-2-124M and LLaMA-3.2-1B (and their
LoRA adapters) at data sizes 2, 4 and 8 and on tp / tp_fsdp meshes, the
mesh's rank layout against JAX's, the loaders' per-rank rows
against the JAX loaders', the flags, and the sharded step at a world of
one, which must be the single-device step bit for bit. The multi-process
runs are ``test_torch_distributed.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.configs import get_config as jget_config
from building_llm_from_scratch_tpu.data import instruct as jinstruct
from building_llm_from_scratch_tpu.data.pretrain import PretrainLoader as JLoader
from building_llm_from_scratch_tpu.data.tokenizers import ByteTokenizer as JByte
from building_llm_from_scratch_tpu.models import init_params as jinit
from building_llm_from_scratch_tpu.models.lora import (
    init_lora_params as jinit_lora,
)
from building_llm_from_scratch_tpu.parallel import MeshPlan as JPlan
from building_llm_from_scratch_tpu.parallel import make_mesh as jmake_mesh
from building_llm_from_scratch_tpu_torch import args as targs
from building_llm_from_scratch_tpu_torch.configs import get_config
from building_llm_from_scratch_tpu_torch.data import instruct as tinstruct
from building_llm_from_scratch_tpu_torch.data.pretrain import PretrainLoader
from building_llm_from_scratch_tpu_torch.data.tokenizers import ByteTokenizer
from building_llm_from_scratch_tpu_torch.models.transformer import (
    build_model,
    param_shapes,
)
from building_llm_from_scratch_tpu_torch.parallel import collectives as coll
from building_llm_from_scratch_tpu_torch.parallel.mesh import Mesh, make_mesh
from building_llm_from_scratch_tpu_torch.parallel.sharding import (
    MeshPlan,
    spec_axis,
)
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import flatten_tree
from test_torch_sft import alpaca_records
from torch_port_helpers import bits

MODELS = [("GPT2", "124M"), ("llama3_2", "1B")]


def _jax_leaves(model, size):
    """Every parameter and LoRA (rank 16) leaf of the full-size model, by
    its path, with its shape (abstract: nothing is allocated)."""
    cfg = jget_config(model, size)
    shapes = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
    lora = jax.eval_shape(lambda p, k: jinit_lora(cfg, p, k, rank=16),
                          shapes, jax.random.PRNGKey(1))
    out = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    out.update({k: tuple(v.shape) for k, v in flatten_tree(lora).items()})
    return out


@pytest.mark.parametrize("model,size", MODELS)
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("mode", ["dp", "fsdp", "zero1"])
def test_specs_equal_the_jax_plan(model, size, n, mode):
    """param_spec and opt_spec of every leaf (the model's, at the port's
    own shapes, and the adapter's) equal the JAX plan's; the odd GPT-2
    vocabulary shards on D at n = 2, leaves under ``fsdp_min_size`` stay
    whole, and the stacked L axis never shards."""
    jplan = JPlan(jmake_mesh(data=n, devices=jax.devices()[:n]), shard_mode=mode)
    plan = MeshPlan(Mesh(n), shard_mode=mode)
    leaves = _jax_leaves(model, size)
    assert {k: v for k, v in leaves.items() if k in param_shapes(
        get_config(model, size))} == param_shapes(get_config(model, size))
    for path, shape in leaves.items():
        names = tuple(path.split("/"))
        assert plan.param_spec(names, shape) == tuple(jplan.param_spec(names, shape)), path
        assert plan.opt_spec(names, shape) == tuple(jplan.opt_spec(names, shape)), path
        for root, spec in (("trainable", plan.param_spec(names, shape)),
                           ("opt_state/1/mu", plan.opt_spec(names, shape))):
            assert plan.state_spec(f"{root}/{path}", shape) == spec
            if "blocks" in names:
                assert spec_axis(spec) != 0
    assert plan.state_spec("opt_state/1/count", ()) == ()
    assert plan.state_spec("step", ()) == ()
    if mode == "fsdp":
        # the rule's edges: V = 50257 is odd, 768-wide norms are small
        if model == "GPT2" and n == 2:
            assert plan.param_spec(("tok_emb", "weight"), (50257, 768)) == (None, "data")
            assert plan.param_spec(("head", "weight"), (768, 50257)) == ("data", None)
        small = [p for p, s in leaves.items() if int(np.prod(s)) < 1024]
        assert all(plan.param_spec(tuple(p.split("/")), leaves[p]) == ()
                   for p in small)
        assert small or model != "GPT2"     # GPT-2's final norm: 768


@pytest.mark.parametrize("model,size", MODELS)
@pytest.mark.parametrize("mode,data,tp", [("tp", 1, 2), ("tp", 2, 4), ("tp_fsdp", 2, 2),
                                          ("tp_fsdp", 4, 2)])
def test_tp_specs_equal_the_jax_plan(model, size, mode, data, tp):
    """tp and tp_fsdp specs of every leaf equal the JAX plan's on a (data,
    1, tp) mesh: the Megatron rules, GPT-2's odd vocabulary left whole on
    the model axis while LLaMA's splits, tp_fsdp's data axis never the tp
    one."""
    n = data * tp
    jplan = JPlan(jmake_mesh(data=data, model=tp, devices=jax.devices()[:n]),
                  shard_mode=mode)
    plan = MeshPlan(Mesh(data, 1, tp), shard_mode=mode)
    for path, shape in _jax_leaves(model, size).items():
        names = tuple(path.split("/"))
        assert plan.param_spec(names, shape) == tuple(jplan.param_spec(names, shape)), path
        assert plan.opt_spec(names, shape) == tuple(jplan.opt_spec(names, shape)), path
    cfg = get_config(model, size)
    split = plan.param_spec(("head", "weight"), (cfg.emb_dim, cfg.vocab_size))
    assert (spec_axis(split, "model") == 1) == (model != "GPT2")


def test_state_index_and_local_slices():
    plan = MeshPlan(Mesh(4), "fsdp", rank=2)
    shape = (12, 768, 2304)
    assert plan.state_index("trainable/blocks/attn/wq", shape) == \
        [[0, 12], [0, 768], [1152, 1728]]
    assert plan.state_index("frozen/final_norm/scale", (768,)) == [[0, 768]]
    t = torch.arange(8 * 6).reshape(8, 6)
    assert torch.equal(MeshPlan(Mesh(2), "fsdp", rank=1).local(t, 1), t[:, 3:])
    assert plan.local(t, None) is t
    # the unique shards in the JAX save's order, the rank's own and whether
    # it writes one (the lowest rank holding a shard does)
    assert MeshPlan(Mesh(4), "fsdp", rank=2).leaf_layout((5,), ()) == \
        ((5,), [[[0, 5]]], None, [[0, 5]])
    assert MeshPlan(Mesh(2), "fsdp", rank=1).leaf_layout((4, 6), (None, "data")) == \
        ((4, 6), [[[0, 4], [0, 3]], [[0, 4], [3, 6]]], 1, [[0, 4], [3, 6]])
    # on (2, 1, 2): a model-sharded leaf's shards are written by the data-0 ranks
    assert MeshPlan(Mesh(2, 1, 2), "tp", rank=3).leaf_layout((4, 6), (None, "model")) == \
        ((4, 6), [[[0, 4], [0, 3]], [[0, 4], [3, 6]]], None, [[0, 4], [3, 6]])
    # a rank of a (2, 1, 2) tp_fsdp mesh holds its data and model slices
    tp = MeshPlan(Mesh(2, 1, 2), "tp_fsdp", rank=3)
    assert tp.state_index("trainable/blocks/attn/wq", shape) == \
        [[0, 12], [384, 768], [1152, 2304]]
    assert tp.state_index("trainable/blocks/attn/wo", (12, 2304, 768)) == \
        [[0, 12], [1152, 2304], [384, 768]]
    with pytest.raises(ValueError):
        MeshPlan(Mesh(2), "pp")
    with pytest.raises(ValueError):
        MeshPlan(Mesh(2), "dp", rank=2)


def test_make_mesh_lays_ranks_out_as_jax():
    """``make_mesh(data=-1, seq, model)`` takes the JAX sizes and rank
    order (the devices reshaped to (data, seq, model)); a product that is
    not the world raises."""
    assert make_mesh(world_size=4).shape == {"data": 4, "seq": 1, "model": 1}
    assert make_mesh().data == 1
    mesh = make_mesh(seq=2, model=2, world_size=8)
    assert mesh.shape == {"data": 2, "seq": 2, "model": 2}
    jmesh = jmake_mesh(data=-1, seq=2, model=2, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(8):
        c = mesh.coords(r)
        assert ids[c["data"], c["seq"], c["model"]] == r
    assert mesh.line(5, "model") == [4, 5] and mesh.line(5, "data") == [1, 5]
    assert mesh.line(5, "data_seq") == [1, 3, 5, 7]
    with pytest.raises(ValueError):
        make_mesh(data=3, world_size=4)
    with pytest.raises(ValueError):
        make_mesh(model=3, world_size=4)


def test_collectives_without_a_group_are_identities():
    coll.reset_counters()
    x = torch.arange(6.0).reshape(2, 3)
    assert coll.all_reduce(x) is x and torch.equal(x, torch.arange(6.0).reshape(2, 3))
    out = torch.empty(6)
    coll.all_gather_into(out, x)
    assert torch.equal(out, x.reshape(-1))
    assert coll.gather_full(x, None) is x
    assert coll.broadcast_object({"a": 1}) == {"a": 1}
    assert coll.agree(True) and not coll.agree(False, "min")
    assert coll.counters() == {} and coll.world() == 1 and coll.is_coordinator()


def test_collectives_on_a_one_rank_group(tmp_path):
    """In a one-rank gloo group the wrappers run their collectives, count
    them by dtype, and give the identity."""
    from building_llm_from_scratch_tpu_torch.parallel import mesh

    assert mesh.default_backend("cuda") == "nccl"
    assert mesh.default_backend("cpu") == "gloo"
    mesh.initialize_distributed(init_method=f"file://{tmp_path}/rv", rank=0,
                                world_size=1, device="cpu")
    try:
        coll.reset_counters()
        x = torch.arange(12.0).reshape(3, 4).bfloat16()
        out = torch.empty(12, dtype=torch.bfloat16)
        coll.all_gather_into(out, x)
        shard = torch.empty(3, 4, dtype=torch.bfloat16)
        coll.reduce_scatter_into(shard, x)
        full = coll.gather_full(x, 1)
        coll.all_reduce(x)
        assert torch.equal(out, x.reshape(-1)) and torch.equal(shard, x)
        assert torch.equal(full, x)
        c = coll.counters()
        assert {k: v["calls"] for k, v in c.items()} == {
            "all_gather/bf16": 2, "reduce_scatter/bf16": 1, "all_reduce/bf16": 1}
        assert c["reduce_scatter/bf16"]["bytes"] == 24
        assert coll.broadcast_object("x") == "x" and coll.agree(True, "min")
    finally:
        mesh.shutdown_distributed()


def test_initialize_distributed_never_falls_back_to_gloo(tmp_path):
    """Asking for CUDA without a card raises: NCCL is not swapped for gloo,
    nor the card for the CPU."""
    from building_llm_from_scratch_tpu_torch.parallel import mesh

    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        mesh.initialize_distributed(init_method=f"file://{tmp_path}/rv", rank=0,
                                    world_size=1, device="cuda")
    assert not torch.distributed.is_initialized()


TEXT = ("Every effort moves you closer to mastery. " * 12
        + "A quick brown fox jumps over the lazy dog. " * 6)


@pytest.mark.parametrize("count", [2, 3])
def test_loaders_rank_rows_equal_the_jax_loaders(tmp_path, count):
    """Every rank's pretraining and instruction batches (and the step
    counts) equal the JAX loaders' with the same process_index and
    process_count, over two epochs; a resume's ``start`` skips whole
    global batches."""
    path = tmp_path / "corpus.txt"
    path.write_text(TEXT * 2)
    records, apath = alpaca_records(23, tmp_path)
    for r in range(count):
        kw = dict(batch_size=2, max_length=16, train_ratio=0.9, seed=7,
                  process_index=r, process_count=count)
        jl, tl = JLoader(JByte(), **kw), PretrainLoader(ByteTokenizer(), **kw)
        assert tl.get_total_steps_epoch([str(path)]) == \
            jl.get_total_steps_epoch([str(path)]) > 0
        jtr, _ = jl.create_datasets_for_file(str(path), "<|endoftext|>")
        ttr, _ = tl.create_datasets_for_file(str(path), "<|endoftext|>")
        for epoch in (0, 1):
            jb = list(jl.batches(jtr, shuffle=True, epoch=epoch))
            tb = list(tl.batches(ttr, shuffle=True, epoch=epoch))
            assert len(tb) == len(jb) > 0
            for a, b in zip(tb, jb):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            late = list(tl.batches(ttr, shuffle=True, epoch=epoch, start=2))
            np.testing.assert_array_equal(late[0][0], tb[2][0])
        ikw = dict(batch_size=2, max_length=192, pad_token_id=256, seed=7,
                   process_index=r, process_count=count)
        jil = jinstruct.InstructLoader(JByte(), **ikw)
        til = tinstruct.InstructLoader(ByteTokenizer(), **ikw)
        assert til.get_total_steps_epoch([str(apath)]) == \
            jil.get_total_steps_epoch([str(apath)])
        (jds, _), (tds, _) = jil.create_datasets(records), til.create_datasets(records)
        jb = list(jil.batches(jds, shuffle=True, epoch=1))
        tb = list(til.batches(tds, shuffle=True, epoch=1))
        assert len(tb) == len(jb) == til.num_batches(tds) > 0
        for a, b in zip(tb, jb):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def _base(extra):
    return ["--mode", "train", "--model", "llama3_2", "--num_params", "1B",
            "--debug", "--byte_tokenizer", "--data_dir", "."] + extra


@pytest.mark.parametrize("flag", ["--tp", "--sp", "--pp", "--pp_micro"])
def test_parallel_flags_take_the_jax_checks_or_are_refused(flag, capsys):
    """--tp, --sp, --pp and --pp_micro are taken with the JAX CLI's checks
    and words: --pp and --pp_micro only with --shard_mode pp."""
    multi = ["--run_type", "multi_chip"]
    if flag == "--tp":
        args = targs.get_args(_base(multi + ["--shard_mode", "tp", "--tp", "2"]))
        assert (args.shard_mode, args.tp, args.sp) == ("tp", 2, 1)
        with pytest.raises(ValueError, match=r"--tp > 1 requires --shard_mode tp, "
                                             r"tp_fsdp or pp\."):
            targs.get_args(_base(multi + ["--tp", "2"]))
    elif flag == "--sp":
        args = targs.get_args(_base(multi + ["--shard_mode", "fsdp", "--sp", "2"]))
        assert (args.shard_mode, args.sp) == ("fsdp", 2)
        with pytest.raises(ValueError, match=r"--sp > 1 requires --run_type "
                                             r"multi_chip\."):
            targs.get_args(_base(["--sp", "2"]))
    else:
        args = targs.get_args(_base(multi + ["--shard_mode", "pp", "--batch_size", "8",
                                             flag, "2"]))
        assert args.shard_mode == "pp" and getattr(args, flag[2:]) == 2
        with pytest.raises(ValueError, match=r"--pp/--pp_micro only take effect with "
                                             r"--shard_mode pp\."):
            targs.get_args(_base(multi + [flag, "2"]))


@pytest.mark.parametrize("mode", ["tp", "tp_fsdp", "pp"])
def test_shard_modes_take_the_jax_checks_or_are_refused(mode, capsys):
    """tp and tp_fsdp are taken with --tp >= 2, and refused in the JAX
    CLI's words with --tp 1 and with bf16_hybrid; pp is taken (its plan a
    ``PipelinePlan``), and refused in the JAX words with a batch its
    default 8 microbatches do not divide and with bf16_hybrid."""
    multi = ["--run_type", "multi_chip", "--shard_mode", mode]
    if mode == "pp":
        from building_llm_from_scratch_tpu_torch.build_components import build_plan
        from building_llm_from_scratch_tpu_torch.parallel import PipelinePlan

        args = targs.get_args(_base(multi + ["--batch_size", "8"]))
        plan = build_plan(args)
        assert isinstance(plan, PipelinePlan) and (plan.n_stages, plan.n_micro) == (1, 8)
        with pytest.raises(ValueError, match=r"--batch_size 4 must be divisible by "
                                             r"--pp_micro 8\."):
            targs.get_args(_base(multi))
        with pytest.raises(ValueError, match="supports --mixed_precision bf16/fp32 only"):
            targs.get_args(_base(multi + ["--batch_size", "8", "--mixed_precision",
                                          "bf16_hybrid"]))
        return
    assert targs.get_args(_base(multi + ["--tp", "2"])).shard_mode == mode
    with pytest.raises(ValueError, match=f"--shard_mode {mode} requires --tp >= 2."):
        targs.get_args(_base(multi))
    with pytest.raises(ValueError, match="bf16_hybrid is not supported with "
                                         f"--shard_mode {mode}"):
        targs.get_args(_base(multi + ["--tp", "2", "--mixed_precision", "bf16_hybrid"]))


def test_shard_mode_flags_checks():
    args = targs.get_args(_base(["--run_type", "multi_chip", "--shard_mode", "fsdp"]))
    assert (args.run_type, args.shard_mode) == ("multi_chip", "fsdp")
    assert targs.get_args(_base([])).run_type == "single_chip"
    with pytest.raises(ValueError, match="requires --run_type multi_chip"):
        targs.get_args(_base(["--shard_mode", "zero1"]))
    with pytest.raises(ValueError, match="does not compose"):
        targs.get_args(_base(["--run_type", "multi_chip", "--grad_accum", "2",
                              "--mixed_precision", "bf16_hybrid"]))


def _steps(cfg, plan_mode, policy=None, lora=False, grad_accum=1, n=3):
    """Three steps from the same seeded model and batches: the single
    device step (``plan_mode`` None) or the sharded one at a world of one
    (no process group). Returns (losses, final whole leaves)."""
    from building_llm_from_scratch_tpu_torch.models.lora import init_lora_params

    model = build_model(cfg, 0, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    plan = None if plan_mode is None else MeshPlan(Mesh(1), plan_mode)
    kw = dict(policy=policy, grad_accum=grad_accum)
    if lora:
        gen = torch.Generator().manual_seed(1)
        adapter = init_lora_params(cfg, gen, 4, "cpu")
        for leaf in flatten_tree(adapter).values():
            leaf.add_(0.01)
        state = tts.init_train_state(adapter, opt, frozen=model, policy=policy,
                                     plan=plan)
        kw.update(lora_alpha=8.0, lora_rank=4)
    else:
        state = tts.init_train_state(model, opt, policy=policy, plan=plan)
    step = (tts.make_train_step(cfg, opt, **kw) if plan is None
            else tts.make_sharded_train_step(cfg, opt, plan, **kw))
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(n):
        x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, cfg.context_length + 1)))
        batch = {"inputs": x[:, :-1], "targets": x[:, 1:],
                 "weights": torch.from_numpy(
                     (rng.random((4, cfg.context_length)) > 0.3).astype(np.float32))}
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    tts.gather_params(state)
    return losses, {k: v.detach().clone() for k, v in state.full.items()}


@pytest.mark.parametrize("case", ["plain", "lora", "accum", "bf16_hybrid"])
def test_world_one_is_the_single_device_step(case, deterministic):
    """At a world of one every mode's sharded step gives the single-device
    step's losses and parameters bit for bit (the collectives are
    identities, the loss share is exactly 1, nothing is cast or folded)."""
    from building_llm_from_scratch_tpu_torch.training.precision import get_policy

    cfg = dataclasses.replace(get_config("llama3_2", "1B", debug=True),
                              vocab_size=512)
    kw = dict(lora=case == "lora", grad_accum=2 if case == "accum" else 1,
              policy=get_policy("bf16_hybrid") if case == "bf16_hybrid" else None)
    ref_losses, ref = _steps(cfg, None, **kw)
    for mode in ("dp", "fsdp", "zero1"):
        losses, got = _steps(cfg, mode, **kw)
        assert losses == ref_losses, mode
        for k, v in ref.items():
            np.testing.assert_array_equal(bits(got[k]), bits(v), err_msg=f"{mode} {k}")


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)
