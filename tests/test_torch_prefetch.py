"""Host/device overlap in the port: the batch prefetcher, the split save
and the asynchronous checkpoint writer (the cases of the JAX package's
``tests/test_prefetch.py``), the trainer with both on, and the loss plot.

The load-bearing property is bit-identical training under overlap: the
prefetcher yields exactly the synchronous stream, and an asynchronous
save writes what the synchronous one writes, read by either package.
Comparisons are exact (no tolerance).
"""

from __future__ import annotations

import itertools
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.training import checkpoint as jckpt
from building_llm_from_scratch_tpu.training.optim import build_optimizer
from building_llm_from_scratch_tpu.training.train_step import (
    init_train_state as jinit_state,
)
from building_llm_from_scratch_tpu_torch.configs import get_config
from building_llm_from_scratch_tpu_torch.data.prefetch import (
    DeviceStager,
    Prefetcher,
)
from building_llm_from_scratch_tpu_torch.data.pretrain import PretrainLoader
from building_llm_from_scratch_tpu_torch.data.tokenizers import ByteTokenizer
from building_llm_from_scratch_tpu_torch.models.transformer import build_model
from building_llm_from_scratch_tpu_torch.training import async_checkpoint as tac
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.async_checkpoint import (
    AsyncCheckpointer,
)
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
)
from building_llm_from_scratch_tpu_torch.training.resilience import (
    validate_checkpoint,
)
from building_llm_from_scratch_tpu_torch.training.trainer import Trainer
from torch_port_helpers import bits, jax_params, small_configs

CORPUS = "the quick brown fox jumps over the lazy dog. " * 220
TRAIN_CORPUS = "the quick brown fox jumps over the lazy dog. " * 24


def tiny_cfg():
    return get_config("GPT2", "124M", debug=True).replace(
        emb_dim=32, hidden_dim=64, n_layers=2, n_heads=2, vocab_size=257,
        context_length=16)


def _worker_threads():
    return [t for t in threading.enumerate()
            if "prefetch-worker" in t.name or "async-ckpt" in t.name]


@pytest.fixture
def deterministic_torch():
    """Deterministic CPU kernels: the embedding backward's index_put sums
    in thread order otherwise."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------------------
# Prefetcher: order, exceptions, shutdown
# ---------------------------------------------------------------------------

def _loader_and_ds(tmp_path, batch_size=2):
    loader = PretrainLoader(ByteTokenizer(), batch_size=batch_size,
                            max_length=16)
    f = tmp_path / "corpus.txt"
    f.write_text(CORPUS)
    train, val = loader.create_datasets_for_file(str(f),
                                                eos_text="<|endoftext|>")
    return loader, train, val


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_bit_identical_sequence(tmp_path, depth):
    """A shuffled two-epoch stream through the prefetcher equals the
    synchronous one, batch for batch, bit for bit."""
    loader, train, _ = _loader_and_ds(tmp_path)
    for epoch in (0, 1):
        sync = list(loader.batches(train, shuffle=True, epoch=epoch))
        pf = Prefetcher(loader.batches(train, shuffle=True, epoch=epoch), depth)
        try:
            fetched = list(pf)
        finally:
            pf.close()
        assert len(fetched) == len(sync) > 0
        for (sx, sy), (fx, fy) in zip(sync, fetched):
            np.testing.assert_array_equal(sx, fx)
            np.testing.assert_array_equal(sy, fy)
    assert not _worker_threads()


def test_prefetcher_mid_epoch_resume_parity(tmp_path):
    """The resume fast-forward happens before the wrap: the prefetched
    resumed stream equals the synchronous resumed stream."""
    loader, train, _ = _loader_and_ds(tmp_path)
    sync = list(loader.batches(train, epoch=0, start=3))
    pf = Prefetcher(loader.batches(train, epoch=0, start=3), 2)
    try:
        fetched = list(pf)
    finally:
        pf.close()
    assert len(fetched) == len(sync) > 0
    assert len(sync) == len(list(itertools.islice(
        loader.batches(train, epoch=0), 3, None)))
    for (sx, _), (fx, _) in zip(sync, fetched):
        np.testing.assert_array_equal(sx, fx)


def test_prefetcher_worker_exception_reraised_at_consumer():
    def boom():
        yield np.zeros(2)
        yield np.ones(2)
        raise RuntimeError("tokenizer exploded")

    pf = Prefetcher(boom(), 2)
    try:
        assert len([next(pf), next(pf)]) == 2
        with pytest.raises(RuntimeError, match="tokenizer exploded"):
            next(pf)
    finally:
        pf.close()
    assert not _worker_threads()


def test_prefetcher_close_mid_stream_never_leaks_thread():
    """close() with the worker blocked on a full queue joins promptly."""
    def endless():
        i = 0
        while True:
            yield np.full(4, i)
            i += 1

    pf = Prefetcher(endless(), 2)
    assert (next(pf) == 0).all()
    time.sleep(0.05)                     # the queue fills up again
    pf.close()
    pf.close()                           # idempotent
    assert not pf.alive
    assert not _worker_threads()


def test_prefetcher_place_fn_runs_once_per_batch():
    calls = []

    def place(x):
        calls.append(int(x[0]))
        return x * 10

    src = [np.full(2, i) for i in range(5)]
    pf = Prefetcher(iter(src), 2, place_fn=place)
    try:
        out = list(pf)
    finally:
        pf.close()
    assert [int(x[0]) for x in out] == [0, 10, 20, 30, 40]
    assert calls == [0, 1, 2, 3, 4]


def test_prefetcher_counts_stalls_on_slow_producer():
    def slow():
        for i in range(4):
            time.sleep(0.05)
            yield i

    pf = Prefetcher(slow(), 2)
    try:
        assert list(pf) == [0, 1, 2, 3]
    finally:
        pf.close()
    # the first pop's wait is the start-up (excluded); the rest starved
    assert pf.stalls >= 2
    assert pf.pops == 4


def test_device_stager_converts_on_the_cpu():
    """On the CPU the stager only converts (no stream, no event): the
    batch's dtypes are the step's."""
    staged = DeviceStager(torch.device("cpu")).stage(
        {"inputs": np.arange(6).reshape(2, 3), "weights": np.ones((2, 3))},
        {"inputs": np.int64, "weights": np.float32})
    assert staged.event is None
    got = staged.ready()
    assert got["inputs"].dtype == torch.int64 and got["weights"].dtype == torch.float32
    np.testing.assert_array_equal(got["inputs"].numpy(), np.arange(6).reshape(2, 3))


# ---------------------------------------------------------------------------
# Trainer integration: bit-identical losses under full overlap
# ---------------------------------------------------------------------------

def _run_trainer(tmp_path, tag, *, prefetch, async_ckpt, n_epochs=2,
                 eval_freq=5):
    datafile = tmp_path / "corpus.txt"
    if not datafile.exists():
        datafile.write_text(TRAIN_CORPUS)
    tok = ByteTokenizer()
    trainer = Trainer(tiny_cfg(), build_model(tiny_cfg(), 0, "cpu"), tok,
                      PretrainLoader(tok, batch_size=2, max_length=16),
                      output_dir=str(tmp_path / f"out_{tag}"),
                      eval_freq=eval_freq, print_sample_iter=10_000,
                      save_ckpt_freq=7, warmup_steps=2, keep_ckpts=2,
                      prefetch=prefetch, async_ckpt=async_ckpt)
    trainer.train_model([str(datafile)], n_epochs=n_epochs, start_context="the ")
    return trainer


def test_trainer_prefetch_async_ckpt_bit_identical_losses(tmp_path,
                                                          deterministic_torch):
    """prefetch 2 + asynchronous checkpoints give the synchronous path's
    exact loss and LR trajectory (shuffle on, two epochs); the periodic
    checkpoints the writer committed validate, retention pruned on commit,
    and they equal the synchronous run's leaf for leaf."""
    ref = _run_trainer(tmp_path, "sync", prefetch=0, async_ckpt=False)
    fast = _run_trainer(tmp_path, "overlap", prefetch=2, async_ckpt=True)
    assert fast.global_step == ref.global_step > 14
    assert fast.tokens_seen == ref.tokens_seen
    assert [m["loss"] for m in fast.step_metrics] == [
        m["loss"] for m in ref.step_metrics]
    assert fast.train_losses == ref.train_losses
    assert fast.val_losses == ref.val_losses
    assert fast.track_lrs == ref.track_lrs
    rows = fast.window_logs
    assert rows and all("prefetch_stall" in r and "prefetch_fill_ratio" in r
                        for r in rows)
    assert all("prefetch_stall" not in r for r in ref.window_logs)
    tagged = sorted(p for p in os.listdir(tmp_path / "out_overlap")
                    if p[len("model_pg_"):].isdigit())
    assert tagged == sorted(p for p in os.listdir(tmp_path / "out_sync")
                            if p[len("model_pg_"):].isdigit())
    assert len(tagged) == 2
    for p in tagged:
        a, b = tmp_path / "out_overlap" / p, tmp_path / "out_sync" / p
        assert validate_checkpoint(str(a)) is None, p
        for f in sorted(os.listdir(b)):
            assert (a / f).read_bytes() == (b / f).read_bytes(), (p, f)
    saves = [s for s in fast.checkpoint_saves if s["tag"].isdigit()]
    assert all({"snapshot_s", "write_s", "overlap_s", "bytes"} <= set(s)
               for s in saves)
    assert not _worker_threads()


def test_trainer_prefetch_eval_does_not_disturb_training_queue(tmp_path,
                                                               deterministic_torch):
    """The evaluation cadence mid-epoch (its own small prefetcher) neither
    drains nor reorders the training stream."""
    ref = _run_trainer(tmp_path, "sync_ev", prefetch=0, async_ckpt=False,
                       n_epochs=1, eval_freq=3)
    fast = _run_trainer(tmp_path, "pf_ev", prefetch=3, async_ckpt=False,
                        n_epochs=1, eval_freq=3)
    assert fast.train_losses == ref.train_losses
    assert fast.val_losses == ref.val_losses
    assert len(fast.train_losses) >= 2


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------

def _tiny_state(seed=0):
    model = build_model(tiny_cfg(), seed, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    return tts.init_train_state(model, opt, seed=1)


def test_async_checkpoint_valid_loadable_and_snapshot_decoupled(tmp_path):
    """An asynchronous save validates, loads through ``load_checkpoint``,
    and holds the state as it was when ``save`` returned: the in-place
    update that follows does not reach the files."""
    state = _tiny_state()
    ck = AsyncCheckpointer()
    path = str(tmp_path / "model_pg_5")
    want = state.params["blocks/attn/wq"].detach().clone()
    ck.save(path, tts.checkpoint_tree(state), {"global_step": 5})
    with torch.no_grad():
        for v in state.params.values():
            v.add_(1.0)
    ck.wait()
    assert validate_checkpoint(path) is None
    other = _tiny_state(seed=3)
    load_checkpoint(path, tts.checkpoint_tree(other))
    np.testing.assert_array_equal(bits(other.params["blocks/attn/wq"]), bits(want))


def test_async_checkpoint_serializes_overlapping_saves(tmp_path, monkeypatch):
    """A second save waits for the first commit: the two writes never
    interleave their staging dirs."""
    events = []
    real_write = tac.ckpt.write_snapshot

    def slow_write(ckpt_dir, snapshot):
        events.append(("start", ckpt_dir))
        time.sleep(0.3)
        out = real_write(ckpt_dir, snapshot)
        events.append(("commit", ckpt_dir))
        return out

    monkeypatch.setattr(tac.ckpt, "write_snapshot", slow_write)
    state = _tiny_state()
    ck = AsyncCheckpointer()
    p1, p2 = str(tmp_path / "model_pg_1"), str(tmp_path / "model_pg_2")
    ck.save(p1, tts.checkpoint_tree(state), {"global_step": 1})
    assert ck.in_flight
    ck.save(p2, tts.checkpoint_tree(state), {"global_step": 2})
    ck.wait()
    assert events == [("start", p1), ("commit", p1), ("start", p2),
                      ("commit", p2)]
    for p in (p1, p2):
        assert validate_checkpoint(p) is None
        assert not os.path.isdir(p + ".tmp")
    assert ck.saves_committed == 2
    assert ck.snapshot_s is not None and ck.write_s >= 0.3


def test_async_checkpoint_write_failure_reraises_on_main_thread(tmp_path,
                                                                monkeypatch):
    def bad_write(ckpt_dir, snapshot):
        raise OSError("disk full")

    monkeypatch.setattr(tac.ckpt, "write_snapshot", bad_write)
    committed = []
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "model_pg_1"), tts.checkpoint_tree(_tiny_state()),
            {"global_step": 1}, on_commit=committed.append)
    with pytest.raises(RuntimeError, match="Async checkpoint write failed"):
        ck.wait()
    ck.wait()                            # consumed: the writer stays usable
    assert committed == []


def test_async_checkpoint_overlaps_training_steps(tmp_path, monkeypatch):
    """While the (slowed) write is in flight, train steps go on."""
    real_write = tac.ckpt.write_snapshot

    def slow_write(ckpt_dir, snapshot):
        time.sleep(0.5)
        return real_write(ckpt_dir, snapshot)

    monkeypatch.setattr(tac.ckpt, "write_snapshot", slow_write)
    state = _tiny_state()
    cfg = state.model.cfg
    step = tts.make_train_step(cfg, topt.AdamW(lambda c: 1e-4))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 257, (2, 17)))
    batch = {"inputs": x[:, :-1], "targets": x[:, 1:]}
    ck = AsyncCheckpointer()
    path = str(tmp_path / "model_pg_overlap")
    ck.save(path, tts.checkpoint_tree(state), {"global_step": 0})
    steps_during = 0
    while ck.in_flight:
        state, m = step(state, batch)
        m["loss"].item()
        steps_during += 1
    ck.wait()
    assert steps_during >= 1
    assert validate_checkpoint(path) is None


def test_async_and_sync_checkpoints_are_interchangeable(tmp_path):
    """The asynchronous writer's files are the synchronous save's, byte for
    byte, and load alike."""
    state = _tiny_state()
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    save_checkpoint(sync_dir, tts.checkpoint_tree(state), {"global_step": 3})
    ck = AsyncCheckpointer()
    ck.save(async_dir, tts.checkpoint_tree(state), {"global_step": 3})
    ck.wait()
    for f in sorted(os.listdir(sync_dir)):
        assert (tmp_path / "sync" / f).read_bytes() == (
            tmp_path / "async" / f).read_bytes(), f
    a, b = _tiny_state(seed=4), _tiny_state(seed=5)
    load_checkpoint(sync_dir, tts.checkpoint_tree(a))
    load_checkpoint(async_dir, tts.checkpoint_tree(b))
    for k in a.params:
        np.testing.assert_array_equal(bits(a.params[k]), bits(b.params[k]))


def test_jax_loads_the_ports_async_checkpoint(tmp_path):
    """A port state after one step, written asynchronously: the JAX
    ``load_checkpoint`` reads it on the JAX template, every leaf bit-equal."""
    jcfg, tcfg = small_configs("gpt2", context_length=32)
    params, np_params = jax_params(jcfg, seed=4)
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    state = tts.init_train_state(model, opt, seed=11)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 33)))
    state, _ = tts.make_train_step(tcfg, opt)(state, {"inputs": x[:, :-1],
                                                      "targets": x[:, 1:]})
    path = str(tmp_path / "model_pg_1")
    ck = AsyncCheckpointer()
    ck.save(path, tts.checkpoint_tree(state), {"global_step": 1})
    ck.wait()
    template = jinit_state(params, build_optimizer(), jax.random.PRNGKey(11))
    loaded = {jckpt._path_str(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(
                  jax.device_get(jckpt.load_checkpoint(path, template)))[0]}
    tree = tts.checkpoint_tree(state)
    assert set(loaded) == set(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(bits(loaded[k]), bits(v), err_msg=k)


# ---------------------------------------------------------------------------
# the CLI: the new flags and the loss plot
# ---------------------------------------------------------------------------

def _cli(tmp_path, extra):
    from building_llm_from_scratch_tpu_torch import main as tmain

    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    (data / "c.txt").write_text(TRAIN_CORPUS[:330])
    out = tmp_path / "out"
    trainer = tmain.run(["--mode", "train", "--model", "GPT2", "--num_params",
                         "124M", "--debug", "--byte_tokenizer", "--device", "cpu",
                         "--data_dir", str(data), "--output_dir", str(out),
                         "--n_epochs", "1", "--batch_size", "2",
                         "--eval_freq", "4", "--print_sample_iter", "1000",
                         "--save_ckpt_freq", "5", *extra])
    return trainer, out


def test_cli_runs_every_new_flag_and_plots_the_losses(tmp_path):
    """The ported flags together through ``main.run``: the fp16 policy's
    metrics (every step's scale follows the skip rule from 2^15),
    accumulation, remat, prefetch and asynchronous saves; the run writes
    ``losses.pdf`` beside its checkpoints."""
    trainer, out = _cli(tmp_path, ["--mixed_precision", "fp16", "--grad_accum",
                                   "2", "--use_actv_ckpt", "--prefetch", "2",
                                   "--async_ckpt", "on"])
    assert trainer.cfg.use_actv_ckpt and trainer.grad_accum == 2
    assert trainer.policy.name == "fp16" and trainer.watchdog is None
    scale = 2.0 ** 15
    assert len(trainer.step_metrics) == trainer.global_step >= 6
    for m in trainer.step_metrics:
        scale = max(scale / 2, 1.0) if m["skipped"] else scale
        assert m["loss_scale"] == scale, trainer.step_metrics
    assert (out / "losses.pdf").stat().st_size > 0
    assert validate_checkpoint(str(out / "model_pg_final")) is None
    assert validate_checkpoint(str(out / "model_pg_5")) is None
    assert not _worker_threads()


def test_cli_without_matplotlib_warns_and_goes_on(tmp_path, monkeypatch, caplog):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    trainer, out = _cli(tmp_path, ["--data_type", "fp16", "--prefetch", "0"])
    assert trainer.policy.name == "fp16"
    assert not (out / "losses.pdf").exists()
    assert (out / "model_pg_final.npz").exists()
    assert any("losses.pdf not drawn: matplotlib" in r.getMessage()
               for r in caplog.records)
