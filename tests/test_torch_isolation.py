"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points ask for CUDA unless told to use the CPU, its CLI rejects the
JAX flags it does not carry, and ``chip_smoke.py`` refuses to report
without a card."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "building_llm_from_scratch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "building_llm_from_scratch_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_entry_points_import_no_jax():
    code = (
        "import sys\n"
        "import building_llm_from_scratch_tpu_torch.main\n"
        "import building_llm_from_scratch_tpu_torch.serving.engine\n"
        "import building_llm_from_scratch_tpu_torch.serving.frontend\n"
        "import building_llm_from_scratch_tpu_torch.training.checkpoint\n"
        "import building_llm_from_scratch_tpu_torch.training.trainer\n"
        "import building_llm_from_scratch_tpu_torch.build_components\n"
        "import building_llm_from_scratch_tpu_torch.data.pretrain\n"
        "import building_llm_from_scratch_tpu_torch.ops.fused_attention\n"
        "import building_llm_from_scratch_tpu_torch.ops._kernels\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib') or m == "
        "'building_llm_from_scratch_tpu' or m.startswith("
        "'building_llm_from_scratch_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout


def test_no_jax_import_in_the_port_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def _requests(tmp_path, n=3):
    path = tmp_path / "req.jsonl"
    path.write_text("".join(json.dumps({"prompt_ids": [5 + i, 9, 2],
                                        "max_new_tokens": 4, "ignore_eos": True})
                            + "\n" for i in range(n)))
    return path


def test_cli_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    from building_llm_from_scratch_tpu_torch.main import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    req = _requests(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["--mode", "serve", "--debug", "--serve_prompts", str(req)])
    out = tmp_path / "out.jsonl"
    eng = run(["--mode", "serve", "--debug", "--device", "cpu",
               "--serve_prompts", str(req), "--serve_out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [len(x["token_ids"]) for x in lines] == [4, 4, 4]
    assert eng.stats()["requests_finished"] == 3


def test_train_cli_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    from building_llm_from_scratch_tpu_torch.main import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "a.txt").write_text("Every effort moves you. " * 20)
    flags = ["--mode", "train", "--model", "llama3_2", "--num_params", "1B",
             "--debug", "--byte_tokenizer", "--data_dir", str(tmp_path),
             "--output_dir", str(tmp_path / "out"), "--n_epochs", "1",
             "--batch_size", "8", "--print_sample_iter", "1000"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(flags)
    trainer = run(flags + ["--device", "cpu"])
    assert trainer.global_step == 3 and trainer.model.device.type == "cpu"
    assert (tmp_path / "out" / "model_pg_final.npz").is_file()


def test_cli_rejects_unported_jax_flags_by_name(tmp_path, capsys):
    from building_llm_from_scratch_tpu_torch.args import get_args

    req = str(_requests(tmp_path))
    with pytest.raises(SystemExit):
        get_args(["--mode", "serve", "--serve_prompts", req,
                  "--serve_port", "8000", "--serve_kv_paged=on"])
    err = capsys.readouterr().err
    assert "--serve_port" in err and "--serve_kv_paged" in err
    with pytest.raises(ValueError, match="not ported"):
        get_args(["--mode", "finetune_fleet", "--serve_prompts", req])
    args = get_args(["--mode", "serve", "--serve_prompts", req])
    assert (args.device, args.serve_slots, args.data_type) == ("cuda", 8, "fp32")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
