"""Entry point: ``python -m building_llm_from_scratch_tpu_torch --mode serve``."""

from __future__ import annotations

from typing import List, Optional

from building_llm_from_scratch_tpu_torch.args import get_args


def run(argv: Optional[List[str]] = None):
    """Parse the flags and serve; returns the shut-down engine."""
    from building_llm_from_scratch_tpu_torch.serving.frontend import run_serve

    return run_serve(get_args(argv))


if __name__ == "__main__":
    run()
