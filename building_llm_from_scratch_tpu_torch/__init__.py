"""PyTorch/CUDA port of ``building_llm_from_scratch_tpu``.

The JAX package beside it is the reference. This package imports neither
JAX nor the JAX package; its entry points run on ``cuda`` unless the caller
asks for ``device="cpu"``.
"""
