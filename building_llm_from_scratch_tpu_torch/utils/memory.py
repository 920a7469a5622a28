"""Parameter counting and device-memory accounting (port of the JAX
package's ``utils/memory.py``).

The device's figures come from the CUDA caching allocator
(``torch.cuda.memory_stats``): bytes in use, the peak since the process
started (or since ``torch.cuda.reset_peak_memory_stats``) and the card's
total memory. On the CPU there are none, and the functions say so rather
than inventing a number.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

from building_llm_from_scratch_tpu_torch.configs import DTYPE_BYTES


def _leaves(tree: Any):
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif node is not None:
            yield node


def count_params(params: Any) -> int:
    """Total number of scalar parameters in a tree of tensors or arrays
    (nested dicts, lists; a module's ``parameters()`` as a list)."""
    total = 0
    for leaf in _leaves(params):
        shape = getattr(leaf, "shape", ())
        n = 1
        for d in shape:
            n *= int(d)
        total += n
    return total


def estimate_memory_static(n_params: int, dtype: str = "fp32",
                           optimizer: str = "adamw") -> float:
    """Static memory estimate in GB by the 4N Adam rule (parameters,
    gradients and the two Adam moments)."""
    mult = 4 if optimizer == "adamw" else 2
    return mult * n_params * DTYPE_BYTES[dtype] / 1024**3


def estimate_memory_dynamic(n_params: int, n_trainable: int,
                            dtype: str = "fp32") -> float:
    """Parameters plus gradients of the trainable ones, in GB."""
    return (n_params + n_trainable) * DTYPE_BYTES[dtype] / 1024**3


def host_rss_bytes() -> Optional[int]:
    """This process's resident set size in bytes (``/proc/self/status``,
    else the ``getrusage`` peak), or None."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak * 1024 if sys.platform != "darwin" else peak
    except Exception:
        return None


def device_memory_stats(device=None) -> Dict[str, int]:
    """The allocator's bytes of one card: ``bytes_in_use``,
    ``peak_bytes_in_use`` (``torch.cuda.max_memory_allocated``),
    ``bytes_reserved`` and ``bytes_limit`` (the card's total memory); ``{}``
    off the card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device)
                               .total_memory)}


def log_device_memory(logger, prefix: str = "", device=None) -> None:
    """Log in-use, peak and total memory of the card (``device``, else
    every visible card), or that the CPU run has no device figures."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        logger.info("%s%s: no device memory statistics", prefix, device)
        return
    if device is None and not torch.cuda.is_available():
        logger.info("%scpu: no device memory statistics", prefix)
        return
    devices = ([torch.device(device)] if device is not None else
               [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    for d in devices:
        stats = device_memory_stats(d)
        logger.info("%s%s: in_use=%.2fGB peak=%.2fGB limit=%.2fGB", prefix, d,
                    stats["bytes_in_use"] / 1024**3,
                    stats["peak_bytes_in_use"] / 1024**3,
                    stats["bytes_limit"] / 1024**3)
