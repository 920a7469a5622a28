"""Pretrained-weight loading from local files (the port's copy of the JAX
package's ``weights/``): the readers, the per-family file tables and the
three name maps into the port's flat stacked parameters."""

from building_llm_from_scratch_tpu_torch.weights.fetch import (
    HF_GPT2_REPOS,
    HF_LLAMA_FILES,
    LazyStateDict,
    load_hf_weights,
    load_state_dict_file,
    read_safetensors,
    read_torch_checkpoint,
)
from building_llm_from_scratch_tpu_torch.weights.mappings import (
    convert_gpt2_state_dict,
    convert_llama_hf_state_dict,
    convert_llama_meta_state_dict,
)

__all__ = [
    "HF_GPT2_REPOS",
    "HF_LLAMA_FILES",
    "LazyStateDict",
    "convert_gpt2_state_dict",
    "convert_llama_hf_state_dict",
    "convert_llama_meta_state_dict",
    "load_hf_weights",
    "load_state_dict_file",
    "read_safetensors",
    "read_torch_checkpoint",
]
