"""Pretrained-weight loading in the port (``weights/``) against the JAX
package's converters and readers, and against ``transformers``.

Golden logits: random-initialised ``transformers`` GPT-2 and LLaMA models
built offline from configs (HF naming and fusing, Meta naming by renaming)
are the oracle; the port's forward on the converted weights agrees to
1e-4 absolute and relative in fp32, the JAX test's bound. The port's
converted leaves are bit-equal to the JAX converters' on the same state
dict for all three namings (fp32, and bf16 through the cast), its readers
give the exact tensors ``safetensors`` and ``torch.save`` wrote, and
``load_hf_weights`` from a local directory gives the JAX loader's leaves
bit for bit. The CLI refuses ``--load_weights`` without ``--weights_dir``
and beside ``--init_params_from``, and serves and trains from loaded
weights.
"""

import json

import numpy as np
import pytest
import torch

from building_llm_from_scratch_tpu import weights as jweights
from building_llm_from_scratch_tpu.configs import ModelConfig as JConfig
from building_llm_from_scratch_tpu_torch.configs import ModelConfig, get_config
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    build_model,
    forward,
)
from building_llm_from_scratch_tpu_torch.training.checkpoint import flatten_tree
from building_llm_from_scratch_tpu_torch.weights import (
    LazyStateDict,
    convert_gpt2_state_dict,
    convert_llama_hf_state_dict,
    convert_llama_meta_state_dict,
    load_hf_weights,
    load_state_dict_file,
    read_safetensors,
    read_torch_checkpoint,
)
from torch_port_helpers import bits

transformers = pytest.importorskip("transformers")

GPT2_TINY = dict(
    name="gpt2-tiny", vocab_size=96, context_length=32, emb_dim=32,
    n_heads=2, n_layers=3, hidden_dim=128, n_kv_groups=2,
    norm="layernorm", positional="learned", activation="gelu",
    qkv_bias=True, attn_out_bias=True, mlp_bias=True, norm_bias=True,
    drop_rate=0.0, dtype="fp32")

LLAMA_TINY = dict(
    name="llama-tiny", vocab_size=96, context_length=64, emb_dim=32,
    n_heads=4, n_layers=3, hidden_dim=64, n_kv_groups=2,
    norm="rmsnorm", positional="rope", activation="swiglu",
    rope_base=10_000.0, rmsnorm_eps=1e-5, drop_rate=0.0, dtype="fp32",
    eos_id=2, eos_text="</s>")


def _sd(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _np(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def gpt2_oracle():
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    hf = GPT2LMHeadModel(GPT2Config(
        vocab_size=96, n_positions=32, n_embd=32, n_layer=3, n_head=2,
        activation_function="gelu", resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0, layer_norm_epsilon=1e-5))
    hf.eval()
    return hf


@pytest.fixture(scope="module")
def llama_oracle():
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10_000.0,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False,
        attention_dropout=0.0))
    hf.eval()
    return hf


def _to_meta_naming(hf_sd: dict, n_layers: int) -> dict:
    """An HF LLaMA state dict renamed into Meta's consolidated naming
    (w1 = gate, w3 = up, w2 = down)."""
    meta = {"tok_embeddings.weight": hf_sd["model.embed_tokens.weight"],
            "norm.weight": hf_sd["model.norm.weight"],
            "output.weight": hf_sd["lm_head.weight"]}
    for l in range(n_layers):
        h, m = f"model.layers.{l}", f"layers.{l}"
        for src, dst in (("self_attn.q_proj", "attention.wq"),
                         ("self_attn.k_proj", "attention.wk"),
                         ("self_attn.v_proj", "attention.wv"),
                         ("self_attn.o_proj", "attention.wo"),
                         ("mlp.gate_proj", "feed_forward.w1"),
                         ("mlp.up_proj", "feed_forward.w3"),
                         ("mlp.down_proj", "feed_forward.w2"),
                         ("input_layernorm", "attention_norm"),
                         ("post_attention_layernorm", "ffn_norm")):
            meta[f"{m}.{dst}.weight"] = hf_sd[f"{h}.{src}.weight"]
    return meta


def _logits(flat, cfg, x):
    with torch.no_grad():
        return forward(Transformer(cfg, flat), torch.as_tensor(x)).numpy()


# ---------------------------------------------------------------------------
# golden logits against transformers
# ---------------------------------------------------------------------------

def test_gpt2_golden_logits(gpt2_oracle):
    """The fused-QKV split, the Conv1D layout and the tied head reproduce
    the HF model's logits."""
    cfg = ModelConfig(**GPT2_TINY)
    flat = convert_gpt2_state_dict(_sd(gpt2_oracle), cfg, device="cpu")
    x = np.array([[1, 5, 9, 2, 44, 91, 3, 17]], np.int64)
    with torch.no_grad():
        want = gpt2_oracle(torch.tensor(x)).logits.numpy()
    np.testing.assert_allclose(_logits(flat, cfg, x), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("naming", ["hf", "meta"])
def test_llama_golden_logits(llama_oracle, naming):
    """GQA, RoPE, SwiGLU and RMSNorm on the converted weights reproduce the
    HF model's logits, from the HF naming and from Meta's."""
    cfg = ModelConfig(**LLAMA_TINY)
    sd = _sd(llama_oracle)
    flat = (convert_llama_hf_state_dict(sd, cfg, device="cpu") if naming == "hf"
            else convert_llama_meta_state_dict(_to_meta_naming(sd, 3), cfg,
                                               device="cpu"))
    x = np.array([[3, 11, 7, 2, 64, 95, 0, 33, 12, 8]], np.int64)
    with torch.no_grad():
        want = llama_oracle(torch.tensor(x)).logits.numpy()
    np.testing.assert_allclose(_logits(flat, cfg, x), want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the converters against the JAX package's
# ---------------------------------------------------------------------------

def _jax_leaves(tree) -> dict:
    import jax

    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(tree)).items()}


@pytest.mark.parametrize("naming,dtype", [("gpt2", "fp32"), ("hf", "fp32"),
                                          ("meta", "fp32"), ("hf", "bf16"),
                                          ("gpt2", "bf16")])
def test_converted_leaves_bit_equal_to_jax(gpt2_oracle, llama_oracle, naming,
                                           dtype):
    """On the same state dict the port's converter and the JAX one give
    the same leaves, bit for bit (bf16: the same rounding of each fp32
    tensor)."""
    spec = GPT2_TINY if naming == "gpt2" else LLAMA_TINY
    cfg, jcfg = ModelConfig(**dict(spec, dtype=dtype)), JConfig(**dict(spec, dtype=dtype))
    sd = _sd(gpt2_oracle if naming == "gpt2" else llama_oracle)
    if naming == "meta":
        sd = _to_meta_naming(sd, 3)
    port = {"gpt2": convert_gpt2_state_dict, "hf": convert_llama_hf_state_dict,
            "meta": convert_llama_meta_state_dict}[naming](sd, cfg, device="cpu")
    jax_fn = {"gpt2": jweights.convert_gpt2_state_dict,
              "hf": jweights.convert_llama_hf_state_dict,
              "meta": jweights.convert_llama_meta_state_dict}[naming]
    want = _jax_leaves(jax_fn(_np(sd), jcfg))
    assert set(port) == set(want)
    for k, v in want.items():
        assert port[k].dtype == cfg.torch_dtype, k
        np.testing.assert_array_equal(bits(port[k]), bits(v), err_msg=k)


def test_llama_meta_naming_matches_hf_naming(llama_oracle):
    cfg = ModelConfig(**LLAMA_TINY)
    sd = _sd(llama_oracle)
    from_hf = convert_llama_hf_state_dict(sd, cfg, device="cpu")
    from_meta = convert_llama_meta_state_dict(_to_meta_naming(sd, 3), cfg,
                                              device="cpu")
    assert list(from_hf) == list(from_meta)
    for k, v in from_hf.items():
        assert torch.equal(v, from_meta[k]), k


def test_llama_weight_tying_fallback(llama_oracle):
    """No ``lm_head.weight``: the head is a copy of the embedding's
    transpose (its own storage, so training moves them apart)."""
    cfg = ModelConfig(**LLAMA_TINY)
    sd = _sd(llama_oracle)
    del sd["lm_head.weight"]
    flat = convert_llama_hf_state_dict(sd, cfg, device="cpu")
    assert torch.equal(flat["head/weight"], sd["model.embed_tokens.weight"].t())
    assert flat["head/weight"].data_ptr() != flat["tok_emb/weight"].data_ptr()
    assert flat["head/weight"].is_contiguous()


def test_shape_mismatch_and_the_qkv_bias_requirement(gpt2_oracle, llama_oracle):
    cfg = ModelConfig(**GPT2_TINY)
    sd = _sd(gpt2_oracle)
    sd["transformer.h.0.attn.c_attn.weight"] = torch.zeros(8, 24)
    with pytest.raises(ValueError, match="Shape mismatch for "
                       "'h.0.attn.c_attn.weight'"):
        convert_gpt2_state_dict(sd, cfg, device="cpu")
    with pytest.raises(ValueError, match="qkv_bias=True"):
        convert_gpt2_state_dict({}, cfg.replace(qkv_bias=False), device="cpu")
    sd = _sd(llama_oracle)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="model.layers.1.mlp.up_proj.weight"):
        convert_llama_hf_state_dict(sd, ModelConfig(**LLAMA_TINY), device="cpu")


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_safetensors_reader_against_save_file(tmp_path, dtype):
    """Files that ``safetensors.torch.save_file`` wrote, one and two shards:
    every tensor read back exactly (bf16 by its bits), one read each."""
    st = pytest.importorskip("safetensors.torch")
    gen = torch.Generator().manual_seed(0)
    tensors = {f"t{i}": torch.randn(3 + i, 5, generator=gen).to(dtype)
               for i in range(4)}
    tensors["scalar_row"] = torch.arange(7, dtype=torch.int32)
    one = tmp_path / "one.safetensors"
    st.save_file(tensors, str(one))
    lazy = read_safetensors(str(one))
    assert set(lazy) == set(tensors) and len(lazy) == 5 and lazy.bytes_read == 0
    got = {k: lazy[k] for k in lazy}
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(bits(got[k]), bits(v), err_msg=k)
    assert lazy.bytes_read == sum(v.numel() * v.element_size() for v in tensors.values())
    names = sorted(tensors)
    st.save_file({k: tensors[k] for k in names[:2]}, str(tmp_path / "a.safetensors"))
    st.save_file({k: tensors[k] for k in names[2:]}, str(tmp_path / "b.safetensors"))
    both = LazyStateDict([str(tmp_path / "a.safetensors"),
                          str(tmp_path / "b.safetensors")])
    assert sorted(both) == names
    for k in names:
        np.testing.assert_array_equal(bits(both[k]), bits(tensors[k]), err_msg=k)


def test_the_smoke_writer_is_read_by_safetensors(tmp_path):
    """chip_smoke's safetensors writer (it writes phase 8w's files on a
    machine without the package) gives files that ``safetensors`` reads."""
    st = pytest.importorskip("safetensors.torch")
    import chip_smoke

    tensors = [("a", torch.randn(4, 3).to(torch.bfloat16)), ("b", torch.randn(5))]
    chip_smoke.write_safetensors(torch, str(tmp_path / "w.safetensors"), tensors)
    back = st.load_file(str(tmp_path / "w.safetensors"))
    for k, v in tensors:
        np.testing.assert_array_equal(bits(back[k]), bits(v), err_msg=k)


def test_torch_checkpoint_reader(tmp_path):
    """A ``torch.save`` state dict (Meta's ``.pth`` format): tensors back
    exactly, strided and bf16 ones included, non-tensors dropped; the
    dispatcher picks the reader by extension."""
    gen = torch.Generator().manual_seed(1)
    sd = {"w": torch.randn(6, 4, generator=gen).to(torch.bfloat16),
          "t": torch.randn(4, 6, generator=gen).t(),          # non-contiguous
          "v": torch.arange(5, dtype=torch.int64), "step": 3}
    path = tmp_path / "consolidated.00.pth"
    torch.save(sd, str(path))
    got = read_torch_checkpoint(str(path))
    assert set(got) == {"w", "t", "v"}
    for k in got:
        np.testing.assert_array_equal(bits(got[k].contiguous()),
                                      bits(sd[k].contiguous()), err_msg=k)
    assert set(load_state_dict_file(str(path))) == {"w", "t", "v"}
    with pytest.raises(ValueError, match="Unknown checkpoint format"):
        load_state_dict_file(str(tmp_path / "x.ckpt"))


# ---------------------------------------------------------------------------
# load_hf_weights from a local directory
# ---------------------------------------------------------------------------

def _write_family(tmp_path, model_name: str, sd: dict) -> str:
    """``sd`` as the family's files (the loader's table names)."""
    st = pytest.importorskip("safetensors.torch")
    d = tmp_path / model_name
    d.mkdir()
    if model_name == "llama2":
        torch.save(sd, str(d / "consolidated.00.pth"))
    elif model_name == "llama3":
        names = sorted(sd)
        for i in range(4):
            st.save_file({k: sd[k].contiguous() for k in names[i::4]},
                         str(d / f"model-0000{i + 1}-of-00004.safetensors"))
    else:
        st.save_file({k: v.contiguous() for k, v in sd.items()},
                     str(d / "model.safetensors"))
    return str(d)


@pytest.mark.parametrize("model_name,size", [("GPT2", "124M"), ("llama3", "8B"),
                                             ("llama3_2", "1B"), ("llama2", "7B")])
def test_load_hf_weights_from_a_local_dir(tmp_path, gpt2_oracle, llama_oracle,
                                          model_name, size):
    """Each family's files in a local directory (GPT-2 single file,
    LLaMA-3 in four shards, LLaMA-3.2 tied, LLaMA-2 Meta ``.pth``): the
    port's ``load_hf_weights`` gives the JAX ``load_hf_weights``'s leaves
    bit for bit; a missing file is named."""
    spec = GPT2_TINY if model_name == "GPT2" else LLAMA_TINY
    cfg, jcfg = ModelConfig(**spec), JConfig(**spec)
    sd = _sd(gpt2_oracle if model_name == "GPT2" else llama_oracle)
    if model_name == "llama2":
        sd = _to_meta_naming(sd, 3)
    elif model_name == "llama3_2":
        del sd["lm_head.weight"]
    d = _write_family(tmp_path, model_name, sd)
    port = load_hf_weights(model_name, size, cfg, weights_dir=d, device="cpu")
    want = _jax_leaves(jweights.load_hf_weights(model_name, size, jcfg,
                                                weights_dir=d))
    assert set(port) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(bits(port[k]), bits(v), err_msg=k)
    with pytest.raises(FileNotFoundError, match="missing checkpoint files"):
        load_hf_weights(model_name, size, cfg, weights_dir=str(tmp_path / "none"),
                        device="cpu")
    with pytest.raises(ValueError, match="local files only"):
        load_hf_weights(model_name, size, cfg, weights_dir=None, device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_refuses_what_the_weight_flags_cannot_do(tmp_path, capsys):
    from building_llm_from_scratch_tpu_torch.args import get_args

    (tmp_path / "init.npz").write_bytes(b"")
    base = ["--mode", "train", "--model", "GPT2", "--debug", "--byte_tokenizer",
            "--data_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="--weights_dir.*local files only"):
        get_args(base + ["--load_weights"])
    with pytest.raises(ValueError, match="requires --load_weights"):
        get_args(base + ["--weights_dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="does not exist"):
        get_args(base + ["--load_weights", "--weights_dir", str(tmp_path / "no")])
    with pytest.raises(ValueError, match="mutually exclusive"):
        get_args(base + ["--load_weights", "--weights_dir", str(tmp_path),
                         "--init_params_from", str(tmp_path / "init.npz")])
    with pytest.raises(ValueError, match="mutually exclusive"):
        get_args(base + ["--resume_from", str(tmp_path),
                         "--init_params_from", str(tmp_path / "init.npz")])
    with pytest.raises(SystemExit):
        get_args(base + ["--fleet_jobs", "jobs.json"])
    err = capsys.readouterr().err
    assert "--fleet_jobs" in err and "ROADMAP queue 1" in err
    assert get_args(base + ["--tokenizer_path", "x"]).tokenizer_path == "x"
    args = get_args(base + ["--async_ckpt", "on", "--prefetch", "0"])
    assert (args.async_ckpt, args.prefetch) == ("on", 0)
    args = get_args(base + ["--load_weights", "--weights_dir", str(tmp_path)])
    assert (args.load_weights, args.resume, args.save_ckpt_freq, args.keep_ckpts,
            args.watchdog, args.loss_spike_factor, args.watchdog_window) == (
        True, "auto", 100, 0, "on", 10.0, 50)
    req = tmp_path / "req.jsonl"
    req.write_text(json.dumps({"prompt_ids": [1, 2]}) + "\n")
    with pytest.raises(SystemExit):
        get_args(["--mode", "serve", "--serve_prompts", str(req),
                  "--save_ckpt_freq", "5"])
    assert "training flag" in capsys.readouterr().err


def test_cli_serves_and_trains_from_loaded_weights(tmp_path):
    """``--load_weights --weights_dir`` through both modes on the CPU: a
    GPT-2 file (q/k/v biases drawn, so the fused split matters) served
    gives the greedy tokens of the same model in process, and a training
    run starts from exactly the file's leaves."""
    import chip_smoke
    from building_llm_from_scratch_tpu_torch import main as tmain
    from building_llm_from_scratch_tpu_torch.serving.engine import DecodeEngine
    from building_llm_from_scratch_tpu_torch.serving.request import SamplingParams

    cfg = get_config("GPT2", "124M", qkv_bias=True, debug=True)
    model = build_model(cfg, 4, "cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, leaf in model.stacked.items():
            if name.rsplit("/", 1)[-1] in ("bq", "bk", "bv", "bias"):
                leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen))
        model.stacked["head/weight"].copy_(model.stacked["tok_emb/weight"].t())
    wdir = tmp_path / "w"
    chip_smoke.write_checkpoint(torch, model, "gpt2", str(wdir))
    prompts = [[5, 9, 2], [7, 7, 1, 3]]
    req = tmp_path / "req.jsonl"
    req.write_text("".join(json.dumps({"prompt_ids": p, "max_new_tokens": 6,
                                       "ignore_eos": True}) + "\n" for p in prompts))
    out = tmp_path / "out.jsonl"
    common = ["--model", "GPT2", "--num_params", "124M", "--debug", "--device",
              "cpu", "--load_weights", "--weights_dir", str(wdir)]
    tmain.run(["--mode", "serve", *common, "--serve_prompts", str(req),
               "--serve_out", str(out), "--serve_slots", "2"])
    got = [json.loads(line)["token_ids"] for line in out.read_text().splitlines()]
    eng = DecodeEngine(model, n_slots=2)
    handles = [eng.submit(p, SamplingParams(max_new_tokens=6, ignore_eos=True))
               for p in prompts]
    while eng.step():
        pass
    assert got == [h.output_ids for h in handles]

    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "c.txt").write_text("Every effort moves you. " * 30)
    captured = {}
    import building_llm_from_scratch_tpu_torch.training.trainer as ttr

    orig = ttr.Trainer._setup

    def spy(self, total):
        captured.update({k: v.clone() for k, v in self.model.stacked.items()})
        return orig(self, total)

    ttr.Trainer._setup = spy
    try:
        trainer = tmain.run(["--mode", "train", *common, "--byte_tokenizer",
                             "--data_dir", str(tmp_path / "data"), "--output_dir",
                             str(tmp_path / "o"), "--n_epochs", "1",
                             "--batch_size", "4", "--print_sample_iter", "1000"])
    finally:
        ttr.Trainer._setup = orig
    assert trainer.global_step >= 1 and trainer.cfg.qkv_bias
    for k, v in model.stacked.items():
        np.testing.assert_array_equal(bits(captured[k]), bits(v), err_msg=k)
