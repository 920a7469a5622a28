"""Train-state checkpoints, resume and fault tolerance in the port
(``training/checkpoint.py``, ``training/resilience.py``, the trainer's
cursor), against the JAX package's format and behaviour: the cases of the
JAX ``tests/test_resilience.py`` and ``tests/test_checkpoint_validation.py``
(the event-sink cases wait for the port's observability), checkpoints read
across the two packages, and stop-and-resume bit-equal to an unbroken run
(pretraining and LoRA SFT), with a control that drops the data cursor.

Tolerances: the port's own round trips and resumes are exact (bits). A
JAX-written train state restores bit for bit; the two further steps on it
agree with JAX's at the fp32 bounds of ``tests/test_torch_training.py``
(loss and grad_norm 1e-5 relative, update_norm 1e-4, parameters 1e-5
absolute).
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu.training import checkpoint as jckpt
from building_llm_from_scratch_tpu.training import resilience as jres
from building_llm_from_scratch_tpu.training.optim import (
    build_optimizer,
    warmup_cosine_schedule,
)
from building_llm_from_scratch_tpu.training.train_step import (
    init_train_state as jinit_state,
    make_train_step as jmake_train_step,
)
from building_llm_from_scratch_tpu_torch.configs import get_config
from building_llm_from_scratch_tpu_torch.data.instruct import InstructLoader
from building_llm_from_scratch_tpu_torch.data.pretrain import PretrainLoader
from building_llm_from_scratch_tpu_torch.data.tokenizers import ByteTokenizer
from building_llm_from_scratch_tpu_torch.models.lora import (
    flatten_lora,
    init_lora_params,
)
from building_llm_from_scratch_tpu_torch.models.transformer import build_model
from building_llm_from_scratch_tpu_torch.training import optim as topt
from building_llm_from_scratch_tpu_torch.training import train_step as tts
from building_llm_from_scratch_tpu_torch.training.checkpoint import (
    checkpoint_metadata,
    flatten_tree,
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
)
from building_llm_from_scratch_tpu_torch.training.resilience import (
    GracefulStopper,
    LossWatchdog,
    TrainingDivergedError,
    find_latest_valid_checkpoint,
    list_checkpoints,
    prune_checkpoints,
    resolve_resume,
    validate_checkpoint,
)
from building_llm_from_scratch_tpu_torch.training.trainer import Trainer
from torch_port_helpers import bits, jax_params, small_configs, to_np32

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

STATE = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
         "b": torch.ones(8)}


def _zeros():
    return {k: torch.zeros_like(v) for k, v in STATE.items()}


def _save(out_dir, tag, step):
    return save_checkpoint(os.path.join(out_dir, f"model_pg_{tag}"), STATE,
                           extra_metadata={"global_step": step})["path"]


def _first_shard(ckpt_dir):
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return os.path.join(ckpt_dir, manifest["leaves"][0]["shards"][0]["file"])


def _flip_byte(path, offset=-1):
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def tiny_cfg(**kw):
    """Smaller than --debug: these tests train real steps. GPT-2 keeps its
    dropout 0.1, so a resume must also restore the dropout stream's step."""
    return get_config("GPT2", "124M", debug=True).replace(
        emb_dim=32, hidden_dim=64, n_layers=2, n_heads=2, vocab_size=257,
        context_length=16, **kw)


def make_trainer(tmp_path, model, **kw):
    tok = ByteTokenizer()
    loader = PretrainLoader(tok, batch_size=2, max_length=16)
    defaults = dict(output_dir=str(tmp_path / "out"), eval_freq=4,
                    print_sample_iter=100000, save_ckpt_freq=100000,
                    warmup_steps=2)
    defaults.update(kw)
    return Trainer(model.cfg, model, tok, loader, **defaults)


@pytest.fixture
def deterministic_torch():
    """torch's deterministic algorithms: the CPU embedding backward
    (index_put with accumulation) sums in a thread-dependent order
    otherwise."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


class StopAfter(GracefulStopper):
    """A SIGTERM landing during step N, deterministically."""

    def __init__(self, after):
        super().__init__(signals=())
        self.after = after

    def should_stop(self):
        self.after -= 1
        return self.after <= 0


# ---------------------------------------------------------------------------
# checkpoint integrity: checksums, truncation, old manifests, fallback
# ---------------------------------------------------------------------------

def test_manifest_records_bytes_and_sha256(tmp_path):
    ck = _save(str(tmp_path), "10", 10)
    with open(os.path.join(ck, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "sharded-v1"
    assert [leaf["path"] for leaf in manifest["leaves"]] == ["b", "w"]
    for leaf in manifest["leaves"]:
        for sh in leaf["shards"]:
            assert sh["bytes"] == os.path.getsize(os.path.join(ck, sh["file"]))
            assert len(sh["sha256"]) == 64
    assert validate_checkpoint(ck) is None


def test_validate_rejects_bitflipped_shard(tmp_path):
    ck = _save(str(tmp_path), "10", 10)
    _flip_byte(_first_shard(ck))
    reason = validate_checkpoint(ck)
    assert reason is not None and "sha256" in reason


def test_validate_rejects_truncated_shard(tmp_path):
    ck = _save(str(tmp_path), "10", 10)
    shard = _first_shard(ck)
    os.truncate(shard, os.path.getsize(shard) - 8)
    reason = validate_checkpoint(ck)
    assert reason is not None and "truncated" in reason


def test_validate_rejects_missing_shard_and_manifest(tmp_path):
    ck = _save(str(tmp_path), "10", 10)
    os.remove(_first_shard(ck))
    assert "missing" in validate_checkpoint(ck)
    assert "manifest" in validate_checkpoint(str(tmp_path / "nope"))


def test_validate_accepts_old_manifest_without_checksums(tmp_path):
    ck = _save(str(tmp_path), "10", 10)
    mpath = os.path.join(ck, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    for leaf in manifest["leaves"]:
        for sh in leaf["shards"]:
            del sh["bytes"], sh["sha256"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    assert validate_checkpoint(ck) is None
    _flip_byte(_first_shard(ck))          # undetectable without checksums
    assert validate_checkpoint(ck) is None


def test_auto_resume_falls_back_past_corrupt_latest(tmp_path):
    out = str(tmp_path)
    _save(out, "10", 10)
    ck20 = _save(out, "20", 20)
    assert find_latest_valid_checkpoint(out) == ck20
    _flip_byte(_first_shard(ck20))
    assert find_latest_valid_checkpoint(out).endswith("model_pg_10")
    assert resolve_resume("auto", None, out).endswith("model_pg_10")
    # fleet checkpoints share the prefix: the predicate skips them quietly
    assert find_latest_valid_checkpoint(
        out, predicate=lambda meta: meta["global_step"] != 10) is None


def test_list_checkpoints_orders_by_step_and_skips_junk(tmp_path):
    out = str(tmp_path)
    _save(out, "5", 5)
    _save(out, "interrupted", 12)
    _save(out, "final", 8)
    (tmp_path / "model_pg_final.npz").write_bytes(b"not a dir")
    os.makedirs(tmp_path / "model_pg_junk")          # no manifest
    found = list_checkpoints(out)
    assert [s for s, _ in found] == [5, 8, 12]
    assert found[-1][1].endswith("model_pg_interrupted")


def test_resolve_resume_modes(tmp_path):
    out = str(tmp_path)
    assert resolve_resume("off", None, out) is None
    assert resolve_resume("auto", None, out) is None
    ck = _save(out, "10", 10)
    assert resolve_resume("auto", None, out) == ck
    assert resolve_resume("off", None, out) is None
    assert resolve_resume("auto", "/explicit/wins", out) == "/explicit/wins"
    assert resolve_resume(ck, None, str(tmp_path / "empty")) == ck


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------

def test_prune_keeps_newest_and_protected_tags(tmp_path):
    out = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        _save(out, str(step), step)
    _save(out, "interrupted", 3)
    _save(out, "final", 5)
    removed = prune_checkpoints(out, keep=2)
    assert sorted(os.path.basename(p) for p in removed) == [
        "model_pg_1", "model_pg_2", "model_pg_3"]
    left = sorted(n for n in os.listdir(out) if n.startswith("model_pg_"))
    assert left == ["model_pg_4", "model_pg_5", "model_pg_final",
                    "model_pg_interrupted"]
    assert prune_checkpoints(out, keep=2) == []
    with pytest.raises(ValueError, match="keep"):
        prune_checkpoints(out, keep=0)


def test_trainer_keep_ckpts_bounds_disk(tmp_path):
    datafile = tmp_path / "c.txt"
    datafile.write_text("the quick brown fox jumps over the lazy dog. " * 8)
    trainer = make_trainer(tmp_path, build_model(tiny_cfg(), 0, "cpu"),
                           save_ckpt_freq=1, keep_ckpts=2)
    trainer.train_model([str(datafile)], n_epochs=1, start_context="the ")
    assert trainer.global_step >= 5
    out = str(tmp_path / "out")
    tagged = sorted(int(n[len("model_pg_"):]) for n in os.listdir(out)
                    if n[len("model_pg_"):].isdigit())
    assert len(tagged) <= 2
    assert tagged[-1] == trainer.global_step
    meta = checkpoint_metadata(os.path.join(out, f"model_pg_{tagged[-1]}"))
    assert meta["cursor"] == {"epoch": 0, "file_index": 0, "file": "c.txt",
                              "batch_index": trainer.global_step}
    assert meta["model"] == "gpt2-124M"
    assert meta["schedule_horizon"] == trainer.global_step
    assert [s["tag"] for s in trainer.checkpoint_saves] == [
        str(i) for i in range(1, trainer.global_step + 1)]


# ---------------------------------------------------------------------------
# clear manifest errors and orphaned staging dirs
# ---------------------------------------------------------------------------

def test_load_missing_manifest_raises_single_clear_error(tmp_path):
    empty = tmp_path / "model_pg_7"
    empty.mkdir()
    with pytest.raises(ValueError, match="manifest.json is missing"):
        load_checkpoint(str(empty), _zeros())
    with pytest.raises(ValueError, match=str(empty)):
        checkpoint_metadata(str(empty))


def test_load_malformed_manifest_raises_single_clear_error(tmp_path):
    ck = tmp_path / "model_pg_7"
    ck.mkdir()
    (ck / "manifest.json").write_text("{not json")
    with pytest.raises(ValueError, match="malformed"):
        load_checkpoint(str(ck), _zeros())
    (ck / "manifest.json").write_text('{"no_leaves": 1}')
    with pytest.raises(ValueError, match="leaves"):
        checkpoint_metadata(str(ck))


def test_validate_never_raises_on_structural_corruption(tmp_path):
    ck = tmp_path / "model_pg_9"
    ck.mkdir()
    for payload in ('{"leaves": [42]}', '{"leaves": [{"shards": [{}]}]}',
                    '{"leaves": "nope"}', "{not json"):
        (ck / "manifest.json").write_text(payload)
        reason = validate_checkpoint(str(ck))
        assert isinstance(reason, str) and reason, payload
    good = _save(str(tmp_path), "5", 5)
    assert find_latest_valid_checkpoint(str(tmp_path)) == good


def test_load_cleans_orphaned_staging_dirs(tmp_path):
    ck = _save(str(tmp_path), "10", 10)
    for suffix in (".tmp", ".old"):
        os.makedirs(ck + suffix)
        with open(os.path.join(ck + suffix, "leaf_junk.npy"), "w") as f:
            f.write("stale")
    target = _zeros()
    restored = load_checkpoint(ck, target)
    assert restored["w"] is target["w"]          # refilled in place
    assert torch.equal(target["w"], STATE["w"])
    assert not os.path.exists(ck + ".tmp")
    assert not os.path.exists(ck + ".old")


def test_interrupted_commit_window_still_resumable(tmp_path):
    """A save cut between the two commit renames leaves only ``.tmp``."""
    ck = _save(str(tmp_path), "10", 10)
    os.rename(ck, ck + ".tmp")
    assert validate_checkpoint(ck) is None
    assert find_latest_valid_checkpoint(str(tmp_path)) == ck
    restored = load_checkpoint(ck, _zeros())
    assert torch.equal(restored["b"], torch.ones(8))


def test_load_rejects_wrong_shape_and_dtype(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"w": torch.ones(4, 4),
                                           "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "ck"), {"w": torch.ones(8, 8),
                                               "b": torch.zeros(8)})
    with pytest.raises(ValueError, match="dtype"):
        load_checkpoint(str(tmp_path / "ck"), {
            "w": torch.ones(4, 4, dtype=torch.bfloat16), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(str(tmp_path / "ck"), {"w": torch.ones(4, 4)})


def test_bf16_checkpoint_roundtrip_is_bit_exact(tmp_path):
    """bf16 leaves go to disk as 2-byte void records with "bfloat16" in
    the manifest, as the JAX package writes them, and come back by a
    view; numpy scalars keep their dtype."""
    state = {"w": (torch.arange(12, dtype=torch.float32) / 7.0
                   ).to(torch.bfloat16).reshape(3, 4),
             "n": np.asarray(3, np.int32)}
    save_checkpoint(str(tmp_path / "ck"), state)
    with open(tmp_path / "ck" / "manifest.json") as f:
        dtypes = {leaf["path"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    assert dtypes == {"n": "int32", "w": "bfloat16"}
    got = load_checkpoint(str(tmp_path / "ck"), {
        "w": torch.zeros(3, 4, dtype=torch.bfloat16), "n": np.asarray(0, np.int32)})
    np.testing.assert_array_equal(bits(got["w"]), bits(state["w"]))
    assert got["n"].dtype == np.int32 and int(got["n"]) == 3
    # and the JAX loader reads the same files
    jgot = jckpt.load_checkpoint(str(tmp_path / "ck"), {
        "w": jnp.zeros((3, 4), jnp.bfloat16), "n": jnp.asarray(0, jnp.int32)})
    np.testing.assert_array_equal(bits(np.asarray(jgot["w"])), bits(state["w"]))


def test_rng_shape_change_keeps_the_template_key(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"rng": np.zeros(4, np.uint32),
                                           "w": torch.ones(2)})
    tmpl = np.asarray([0, 7], np.uint32)
    got = load_checkpoint(str(tmp_path / "ck"), {"rng": tmpl,
                                                 "w": torch.zeros(2)})
    assert got["rng"] is tmpl and torch.equal(got["w"], torch.ones(2))


# ---------------------------------------------------------------------------
# graceful stop and the loss watchdog
# ---------------------------------------------------------------------------

def test_graceful_stopper_signal_sets_flag_and_restores_handlers():
    before_term = signal.getsignal(signal.SIGTERM)
    stopper = GracefulStopper()
    with stopper:
        assert not stopper.should_stop()
        if signal.SIGTERM not in stopper._previous:
            pytest.skip("signal handlers unavailable (non-main thread)")
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not stopper.requested and time.monotonic() < deadline:
            time.sleep(0.01)
        assert stopper.requested and stopper.should_stop()
    assert signal.getsignal(signal.SIGTERM) == before_term


def test_watchdog_halts_on_nonfinite_and_spike():
    wd = LossWatchdog(spike_factor=5.0, window=10, min_history=4)
    for i in range(8):
        wd.observe(i, 2.0 + 0.01 * i)
    with pytest.raises(TrainingDivergedError, match="step 9 spiked.*Recent losses"):
        wd.observe(9, 50.0)
    with pytest.raises(TrainingDivergedError, match="non-finite.*step 10"):
        wd.observe(10, float("nan"))
    wd2 = LossWatchdog(spike_factor=5.0, min_history=4)
    wd2.observe(0, 1.0)
    wd2.observe(1, 100.0)            # short history: no spike check yet
    assert LossWatchdog(window=10).min_history == 10
    with pytest.raises(ValueError, match="spike_factor"):
        LossWatchdog(spike_factor=1.0)


def test_trainer_watchdog_halts_on_diverged_loss(tmp_path):
    datafile = tmp_path / "c.txt"
    datafile.write_text("pack my box with five dozen liquor jugs. " * 12)
    trainer = make_trainer(
        tmp_path, build_model(tiny_cfg(), 0, "cpu"), eval_freq=2,
        watchdog=LossWatchdog(spike_factor=5.0, min_history=1))
    real_setup = trainer._setup

    def poisoned_setup(total_steps):
        real_setup(total_steps)
        real_step = trainer.train_step

        def bad_step(state, batch):
            state, metrics = real_step(state, batch)
            if state.step >= 4:
                metrics = dict(metrics, loss=torch.tensor(float("inf")))
            return state, metrics

        trainer.train_step = bad_step

    trainer._setup = poisoned_setup
    with pytest.raises(TrainingDivergedError, match="non-finite.*step 4"):
        trainer.train_model([str(datafile)], n_epochs=1, start_context="a")


# ---------------------------------------------------------------------------
# interrupted checkpoints and the data-cursor resume
# ---------------------------------------------------------------------------

class InterruptingLoader(PretrainLoader):
    """Raises KeyboardInterrupt after yielding N training batches."""

    def __init__(self, *a, interrupt_after=3, **kw):
        super().__init__(*a, **kw)
        self.remaining = interrupt_after

    def batches(self, dataset, **kw):
        inner = super().batches(dataset, **kw)

        def gen():
            for b in inner:
                if self.remaining <= 0:
                    raise KeyboardInterrupt
                self.remaining -= 1
                yield b
        return gen()


def test_keyboard_interrupt_checkpoint_roundtrips_and_resumes(tmp_path):
    cfg = tiny_cfg()
    datafile = tmp_path / "c.txt"
    datafile.write_text("the quick brown fox jumps over the lazy dog. " * 12)
    tok = ByteTokenizer()
    loader = InterruptingLoader(tok, batch_size=2, max_length=16,
                                interrupt_after=3)
    model = build_model(cfg, 0, "cpu")
    trainer = Trainer(cfg, model, tok, loader, output_dir=str(tmp_path / "out"),
                      eval_freq=100000, print_sample_iter=100000,
                      save_ckpt_freq=100000, warmup_steps=2)
    with pytest.raises(KeyboardInterrupt):
        trainer.train_model([str(datafile)], n_epochs=1, start_context="a")
    assert trainer.global_step == 3
    ck = os.path.join(str(tmp_path / "out"), "model_pg_interrupted")
    meta = checkpoint_metadata(ck)
    assert meta["global_step"] == 3
    assert meta["cursor"] == {"epoch": 0, "file_index": 0, "file": "c.txt",
                              "batch_index": 3}

    other = build_model(cfg, 9, "cpu")
    views = [p for name, l, p in other.leaves() if l is not None]
    resumed = make_trainer(tmp_path, other, resume_from=ck)
    resumed._setup(10)
    assert resumed.global_step == 3 and resumed.state.step == 3
    assert resumed.state.opt_state.count == 3
    assert resumed._resume_cursor == meta["cursor"]
    assert resumed.restored["step"] == 3
    for k, v in model.flat_params().items():
        np.testing.assert_array_equal(bits(other.stacked[k]), bits(v), err_msg=k)
    # the per-layer parameters are views of the refilled stacked leaves
    for name, l, p in other.leaves():
        if l is not None:
            assert torch.equal(p, model.stacked[name][l]), name
    assert all(p is q for p, q in zip(
        views, [p for _, l, p in other.leaves() if l is not None]))


def test_resume_refuses_another_model_and_a_moved_file(tmp_path):
    cfg = tiny_cfg()
    datafile = tmp_path / "c.txt"
    datafile.write_text("the quick brown fox jumps over the lazy dog. " * 12)
    trainer = make_trainer(tmp_path, build_model(cfg, 0, "cpu"),
                           stopper=StopAfter(2))
    trainer.train_model([str(datafile)], n_epochs=1, start_context="a")
    ck = os.path.join(str(tmp_path / "out"), "model_pg_interrupted")
    llama = get_config("llama3_2", "1B", debug=True)
    with pytest.raises(ValueError, match="llama3_2-1B"):
        make_trainer(tmp_path, build_model(llama, 0, "cpu"),
                     resume_from=ck)._setup(10)
    moved = tmp_path / "d.txt"
    moved.write_text(datafile.read_text())
    with pytest.raises(ValueError, match="data_dir contents changed"):
        make_trainer(tmp_path, build_model(cfg, 0, "cpu"),
                     resume_from=ck).train_model([str(moved)], n_epochs=1)


def _pretrain_files(tmp_path):
    files = []
    for i, text in enumerate(("a stitch in time saves nine, they say. ",
                              "many hands make light work, it is said. ")):
        path = tmp_path / f"c{i}.txt"
        path.write_text(text * 20)
        files.append(str(path))
    return files


def _history(t):
    return ([m["loss"] for m in t.step_metrics], t.train_losses, t.val_losses,
            t.global_step, t.tokens_seen)


def test_graceful_stop_resume_matches_unbroken_pretraining(tmp_path,
                                                           deterministic_torch):
    """Stop at a step boundary mid-file, resume through the cursor: the
    remaining per-step losses, the evaluations, the step and token counts
    and the final weights equal the unbroken run's bit for bit (dropout
    0.1 on: the resumed step draws the same masks). Control: the same
    resume with the cursor dropped replays the first batches and differs."""
    files = _pretrain_files(tmp_path)

    def run(out, **kw):
        t = make_trainer(tmp_path, build_model(tiny_cfg(), 0, "cpu"),
                         output_dir=str(tmp_path / out), eval_freq=4, **kw)
        return t.train_model(files, n_epochs=2, start_context="a")

    ref = run("ref")
    assert ref.global_step >= 16
    stopped = run("pre", stopper=StopAfter(7), save_ckpt_freq=3)
    assert stopped.preempted and stopped.global_step == 7
    ck = os.path.join(str(tmp_path / "pre"), "model_pg_interrupted")
    cursor = checkpoint_metadata(ck)["cursor"]
    assert cursor["epoch"] == 0 and 0 < cursor["batch_index"] and cursor["file"] in (
        "c0.txt", "c1.txt")
    resumed = run("pre", resume_from=ck)
    losses, train, val, step, tokens = _history(resumed)
    ref_losses, ref_train, ref_val, ref_step, ref_tokens = _history(ref)
    assert losses == ref_losses[7:]
    assert (step, tokens) == (ref_step, ref_tokens)
    assert train == ref_train[len(ref_train) - len(train):] and len(train) >= 2
    assert val == ref_val[len(ref_val) - len(val):] and np.isfinite(val).all()
    for k, v in ref.model.flat_params().items():
        np.testing.assert_array_equal(bits(resumed.model.stacked[k]), bits(v),
                                      err_msg=k)

    # the control: the same checkpoint without its cursor
    meta_path = os.path.join(ck, "manifest.json")
    with open(meta_path) as f:
        manifest = json.load(f)
    del manifest["metadata"]["cursor"]
    with open(meta_path, "w") as f:
        json.dump(manifest, f)
    control = run("pre", resume_from=ck)
    assert [m["loss"] for m in control.step_metrics][:len(losses)] != losses


def test_graceful_stop_resume_matches_unbroken_lora_sft(tmp_path,
                                                        deterministic_torch):
    """LoRA SFT: the adapter is checkpointed as ``trainable`` and the base
    as ``frozen``; the resumed run's losses, evaluations and adapter equal
    the unbroken run's bit for bit; the base stays the checkpoint's.
    Control: the cursor dropped, the losses differ."""
    # context 256: the Alpaca prompt (~170 byte tokens) is masked, the
    # response and its eos are supervised
    cfg = get_config("llama3_2", "1B", debug=True).replace(
        context_length=256, vocab_size=257, drop_rate=0.0, eos_id=256)
    records = [{"instruction": f"Say {w} twice.", "input": "",
                "output": f"{w} {w}"} for w in
               ("red", "blue", "green", "gold", "gray", "pink", "teal", "rose",
                "lime", "navy", "plum", "sand", "jade", "ruby")]
    data = tmp_path / "a.json"
    data.write_text(json.dumps(records))
    tok = ByteTokenizer()

    def run(out, **kw):
        model = build_model(cfg, 0, "cpu")
        gen = torch.Generator().manual_seed(1)
        lora = init_lora_params(cfg, gen, 4, "cpu")
        loader = InstructLoader(tok, batch_size=2, max_length=256,
                                pad_token_id=cfg.eos_id)
        t = Trainer(cfg, model, tok, loader, output_dir=str(tmp_path / out),
                    eval_freq=3, print_sample_iter=100000, warmup_steps=2,
                    peak_lr=5e-3, lora_params=lora, lora_alpha=8.0, lora_rank=4,
                    **kw)
        return t.finetune_model([str(data)], n_epochs=2)

    ref = run("ref")
    assert ref.global_step == 12 and min(m["loss"] for m in ref.step_metrics) > 0
    stopped = run("pre", stopper=StopAfter(5), save_ckpt_freq=2)
    ck = os.path.join(str(tmp_path / "pre"), "model_pg_interrupted")
    with open(os.path.join(ck, "manifest.json")) as f:
        paths = [leaf["path"] for leaf in json.load(f)["leaves"]]
    assert "frozen/blocks/attn/wq" in paths and "trainable/blocks/attn/wq/A" in paths
    assert stopped.global_step == 5
    resumed = run("pre", resume_from=ck)
    losses, train, val, step, tokens = _history(resumed)
    ref_losses, ref_train, ref_val, *_ = _history(ref)
    assert losses == ref_losses[5:] and step == 12 and tokens == ref.tokens_seen
    assert train == ref_train[-len(train):] and val == ref_val[-len(val):]
    for p, v in flatten_lora(ref.lora_params).items():
        np.testing.assert_array_equal(bits(flatten_lora(resumed.lora_params)[p]),
                                      bits(v), err_msg="/".join(p))
    fresh = build_model(cfg, 0, "cpu").flat_params()
    for k, v in resumed.model.flat_params().items():
        np.testing.assert_array_equal(bits(v), bits(fresh[k]), err_msg=k)

    manifest_path = os.path.join(ck, "manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    del manifest["metadata"]["cursor"]
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    control = run("pre", resume_from=ck)
    assert [m["loss"] for m in control.step_metrics][:len(losses)] != losses


def test_final_checkpoint_resume_trains_more_epochs(tmp_path):
    """A cursor-less (``final``) checkpoint resumes as "train the plan
    again": the horizon grows by the steps taken."""
    files = _pretrain_files(tmp_path)[:1]
    t = make_trainer(tmp_path, build_model(tiny_cfg(), 0, "cpu"))
    t.train_model(files, n_epochs=1, start_context="a")
    t.save_checkpoint("final")
    ck = os.path.join(str(tmp_path / "out"), "model_pg_final")
    more = make_trainer(tmp_path, build_model(tiny_cfg(), 0, "cpu"),
                        resume_from=ck)
    more.train_model(files, n_epochs=1, start_context="a")
    assert more.global_step == 2 * t.global_step
    assert more._schedule_horizon == 2 * t.global_step


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _jax_flat(tree):
    """A JAX tree (the optax state's tuples included) as {path: leaf} by
    the JAX checkpoint's own path names."""
    return {jckpt._path_str(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _jax_state_and_steps(jcfg, params, n_before, n_after, rng):
    sched = warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10)
    opt = build_optimizer(schedule=sched)
    state = jinit_state(params, opt, jax.random.PRNGKey(3))
    step = jmake_train_step(jcfg, opt, lr_schedule=sched)
    batches = [rng.integers(0, jcfg.vocab_size, (2, jcfg.context_length + 1))
               for _ in range(n_before + n_after)]
    feed = lambda x: {"inputs": jnp.asarray(x[:, :-1], jnp.int32),  # noqa: E731
                      "targets": jnp.asarray(x[:, 1:], jnp.int32)}
    for x in batches[:n_before]:
        state, _ = step(state, feed(x))
    saved = jax.device_get(state)
    metrics = []
    for x in batches[n_before:]:
        state, m = step(state, feed(x))
        metrics.append(jax.device_get(m))
    return saved, state, metrics, batches[n_before:]


def test_jax_checkpoint_restores_in_the_port_and_trains_alike(tmp_path):
    """A 2-layer fp32 JAX train state after two steps, written by the JAX
    ``save_checkpoint``: the port restores every leaf bit for bit (params,
    Adam moments, counts, step); two further steps on both agree at the
    fp32 bounds (dropout 0)."""
    jcfg, tcfg = small_configs("llama", context_length=64)
    params, np_params = jax_params(jcfg, seed=2)
    saved, state_j, metrics_j, batches = _jax_state_and_steps(
        jcfg, params, 2, 2, np.random.default_rng(5))
    ck = str(tmp_path / "model_pg_2")
    jckpt.save_checkpoint(ck, saved, extra_metadata={"global_step": 2})
    assert validate_checkpoint(ck) is None

    _, other = jax_params(jcfg, seed=7)
    model = params_from_jax(other, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    state = tts.init_train_state(model, opt, seed=3)
    tts.restore_train_state(state, ck)
    assert state.step == 2 and state.opt_state.count == 2
    want = _jax_flat(saved)
    for k, v in state.params.items():
        np.testing.assert_array_equal(bits(v), bits(want[f"trainable/{k}"]), k)
        np.testing.assert_array_equal(bits(state.opt_state.mu[k]),
                                      bits(want[f"opt_state/1/mu/{k}"]), k)
        np.testing.assert_array_equal(bits(state.opt_state.nu[k]),
                                      bits(want[f"opt_state/1/nu/{k}"]), k)
    step = tts.make_train_step(tcfg, opt)
    for x, mj in zip(batches, metrics_j):
        state, mt = step(state, {"inputs": torch.from_numpy(x[:, :-1]),
                                 "targets": torch.from_numpy(x[:, 1:])})
        for key, tol in (("loss", 1e-5), ("grad_norm", 1e-5),
                         ("update_norm", 1e-4)):
            assert abs(mt[key].item() / float(mj[key]) - 1.0) <= tol, key
        np.testing.assert_allclose(mt["lr"], float(mj["lr"]), rtol=1e-6)
    final_j = flatten_tree(jax.device_get(state_j["trainable"]))
    for k, v in model.flat_params().items():
        np.testing.assert_allclose(to_np32(v), to_np32(final_j[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_port_checkpoint_passes_jax_validation_and_loads_in_jax(tmp_path, dtype):
    """A port train state (after one step) passes the JAX
    ``validate_checkpoint`` and loads with the JAX ``load_checkpoint`` on
    the JAX template of the same config: every leaf bit-equal, in the JAX
    tree's order, ``rng`` = PRNGKey(seed)."""
    jcfg, tcfg = small_configs("gpt2", dtype=dtype, context_length=64)
    params, np_params = jax_params(jcfg, seed=4)
    model = params_from_jax(np_params, tcfg, "cpu")
    opt = topt.AdamW(topt.warmup_cosine_schedule(5e-4, 1e-5, 1e-6, 2, 10))
    state = tts.init_train_state(model, opt, seed=11)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 65)))
    state, _ = tts.make_train_step(tcfg, opt)(state, {"inputs": x[:, :-1],
                                                      "targets": x[:, 1:]})
    ck = str(tmp_path / "model_pg_1")
    save_checkpoint(ck, tts.checkpoint_tree(state), {"global_step": 1})
    assert jres.validate_checkpoint(ck) is None
    template = jinit_state(params, build_optimizer(), jax.random.PRNGKey(11))
    loaded = _jax_flat(jckpt.load_checkpoint(ck, template))
    tree = tts.checkpoint_tree(state)
    assert set(loaded) == set(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(bits(loaded[k]), bits(v), err_msg=k)
    np.testing.assert_array_equal(loaded["rng"],
                                  np.asarray(jax.random.PRNGKey(11)))
    assert int(loaded["step"]) == 1 and int(loaded["opt_state/3/count"]) == 1


def test_a_sharded_jax_checkpoint_restores_in_the_port(tmp_path):
    """A JAX checkpoint of leaves sharded over the host's devices (one file
    a shard, as a multi-device JAX run writes it): the port assembles each
    leaf from its shard files, bit for bit, and validates it."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    mesh = Mesh(np.array(jax.devices()), ("x",))
    n = len(jax.devices())
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4 * n, 6)).astype(np.float32)
    v = rng.standard_normal((3, 2 * n)).astype(np.float32)
    state = {"w": jax.device_put(w, NamedSharding(mesh, PartitionSpec("x", None))),
             "v": jax.device_put(v, NamedSharding(mesh, PartitionSpec(None, "x"))),
             "step": jnp.asarray(4, jnp.int32)}
    ck = str(tmp_path / "model_pg_4")
    jckpt.save_checkpoint(ck, state)
    with open(os.path.join(ck, "manifest.json")) as f:
        shards = {leaf["path"]: len(leaf["shards"]) for leaf in json.load(f)["leaves"]}
    assert shards == {"step": 1, "v": n, "w": n}
    assert validate_checkpoint(ck) is None
    got = load_checkpoint(ck, {"w": torch.zeros(4 * n, 6), "v": torch.zeros(3, 2 * n),
                               "step": np.asarray(0, np.int32)})
    np.testing.assert_array_equal(got["w"].numpy(), w)
    np.testing.assert_array_equal(got["v"].numpy(), v)
    assert int(got["step"]) == 4
