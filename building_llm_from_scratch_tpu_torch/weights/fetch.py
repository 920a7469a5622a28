"""Checkpoint file reading and the per-family file tables (the port's copy
of the JAX package's ``weights/fetch.py``, local files only).

  - ``LazyStateDict`` / ``read_safetensors``: the port's own safetensors
    parser (an 8-byte little-endian header length, a JSON tensor table,
    then raw bytes). A tensor is read when it is asked for, with one seek
    and one read straight into its CPU tensor; bf16 tensors are the raw
    bytes viewed as ``torch.bfloat16``. Several shards form one mapping.
  - ``read_torch_checkpoint``: a ``.pth`` (Meta's ``consolidated.00.pth``)
    through ``torch.load(..., weights_only=True, mmap=True)``, so tensors
    stay mapped from the file until the converter copies them.
  - ``load_hf_weights``: the reference's per-family file tables, read from
    ``weights_dir`` and converted by ``weights/mappings.py``. The hub
    download of the JAX package (``download_hf_weights``) is not ported: the
    port reads local files only.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Dict, List, Mapping, Tuple

import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.weights.mappings import (
    convert_gpt2_state_dict,
    convert_llama_hf_state_dict,
    convert_llama_meta_state_dict,
)

logger = logging.getLogger(__name__)

Flat = Dict[str, torch.Tensor]

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


class LazyStateDict(Mapping):
    """Mapping over one or more safetensors files that reads a tensor when
    it is asked for (one seek and one read of just its bytes), so a
    converter streams a checkpoint tensor by tensor instead of holding it
    whole in host memory."""

    def __init__(self, paths):
        #: name -> (path, torch dtype, shape, file offset, bytes)
        self._entries: Dict[str, Tuple[str, torch.dtype, list, int, int]] = {}
        #: bytes read so far
        self.bytes_read = 0
        for path in paths:
            with open(path, "rb") as f:
                (header_len,) = struct.unpack("<Q", f.read(8))
                header = json.loads(f.read(header_len))
            data_start = 8 + header_len
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                begin, end = meta["data_offsets"]
                self._entries[name] = (path, _SAFETENSORS_DTYPES[meta["dtype"]],
                                       meta["shape"], data_start + begin,
                                       end - begin)

    def __contains__(self, name) -> bool:
        return name in self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, name: str) -> torch.Tensor:
        path, dtype, shape, offset, nbytes = self._entries[name]
        raw = torch.empty(nbytes, dtype=torch.uint8)
        with open(path, "rb") as f:
            f.seek(offset)
            if f.readinto(raw.numpy()) != nbytes:
                raise ValueError(f"{path}: tensor '{name}' is truncated")
        self.bytes_read += nbytes
        return raw.view(dtype).reshape(shape)


def read_safetensors(path: str) -> LazyStateDict:
    """Open one safetensors file as a lazy {name: tensor} mapping."""
    return LazyStateDict([path])


def read_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch zip checkpoint (e.g. Meta's ``consolidated.00.pth``) as
    {name: tensor}, memory-mapped from the file."""
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path} did not contain a state dict")
    return {str(k): v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_state_dict_file(path: str) -> Mapping[str, torch.Tensor]:
    """Read one checkpoint file by extension."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if path.endswith((".pth", ".pt", ".bin")):
        return read_torch_checkpoint(path)
    raise ValueError(f"Unknown checkpoint format: {path}")


# The reference's hf_mapping (Models/GPT2/load_weights.py:6-11).
HF_GPT2_REPOS = {
    "124M": "openai-community/gpt2",
    "355M": "openai-community/gpt2-medium",
    "774M": "openai-community/gpt2-large",
    "1.5B": "openai-community/gpt2-xl",
}

# The reference's repo/file sets (load_weights_llama2.py:80-84,
# load_weights_llama3.py:96-124): (repo, files, naming).
HF_LLAMA_FILES: Dict[str, Tuple[str, List[str], str]] = {
    "llama2": ("meta-llama/Llama-2-7b", ["consolidated.00.pth"], "meta"),
    "llama3": ("meta-llama/Meta-Llama-3-8B",
               [f"model-0000{i}-of-00004.safetensors" for i in range(1, 5)],
               "hf"),
    "llama3_1": ("meta-llama/Llama-3.1-8B",
                 [f"model-0000{i}-of-00004.safetensors" for i in range(1, 5)],
                 "hf"),
    "llama3_2": ("meta-llama/Llama-3.2-1B", ["model.safetensors"], "hf"),
}


def _repo_files(model: str, num_params: str) -> Tuple[str, List[str], str]:
    """(repo_id, filenames, naming) of a model family and size."""
    if model == "GPT2":
        if num_params not in HF_GPT2_REPOS:
            raise ValueError(
                f"No GPT-2 model exists for size '{num_params}'. "
                f"Options: {list(HF_GPT2_REPOS)}")
        return HF_GPT2_REPOS[num_params], ["model.safetensors"], "gpt2"
    if model not in HF_LLAMA_FILES:
        raise ValueError(f"No pretrained weights mapping for model '{model}'")
    return HF_LLAMA_FILES[model]


def _resolve_files(filenames: List[str], weights_dir: str) -> List[str]:
    paths = [os.path.join(weights_dir, f) for f in filenames]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"--weights_dir is missing checkpoint files: {missing}")
    return paths


def load_hf_weights(model: str, num_params: str, cfg: ModelConfig, *,
                    weights_dir: str, device="cuda") -> Flat:
    """Read a family's pretrained checkpoint files (the reference's file
    names) from ``weights_dir`` and convert them into the port's flat
    stacked parameters on ``device``. Safetensors shards stream lazily as
    one mapping; ``.pth`` files are memory-mapped."""
    if not weights_dir:
        raise ValueError("load_hf_weights reads local files only: pass "
                         "weights_dir (the hub download is not ported)")
    _, filenames, naming = _repo_files(model, num_params)
    paths = _resolve_files(filenames, weights_dir)
    if all(p.endswith(".safetensors") for p in paths):
        sd: Mapping[str, torch.Tensor] = LazyStateDict(paths)
    else:
        sd = {}
        for p in paths:
            sd.update(load_state_dict_file(p))
    logger.info("Reading %d tensors for %s-%s from %s", len(sd), model,
                num_params, weights_dir)
    if naming == "gpt2":
        return convert_gpt2_state_dict(sd, cfg, device)
    if naming == "meta":
        return convert_llama_meta_state_dict(sd, cfg, device)
    return convert_llama_hf_state_dict(sd, cfg, device)
