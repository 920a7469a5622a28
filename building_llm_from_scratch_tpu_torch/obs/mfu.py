"""Analytic model FLOPs and MFU against the card's peak (port of the JAX
package's ``obs/mfu.py``).

MFU (model FLOPs utilization) is achieved model FLOPs/s over the card's
peak, counting only the FLOPs the model needs: recomputation under remat
does not inflate it. FLOPs a token, fwd + bwd:

    6 * N_matmul  +  12 * n_layers * emb_dim * seq_len

where ``N_matmul`` is the parameter count without the embedding lookups
(gathers, no FLOPs) but with the output head, and the second term the
attention products (QK^T and AV, fwd + bwd, no causal discount).

The peak is the one the run's dtype can reach: the dense 16-bit
tensor-core rate for bf16 and fp16, the fp32 CUDA-core rate for fp32 (the
port's fp32 GEMMs run in full fp32, TF32 off). ``DEVICE_SPECS`` holds
NVIDIA's data-sheet figures for the H100 SXM, NVL and PCIe; another device
(the CPU among them) has no peak, and the MFU is then None ("MFU n/a").
"""

from __future__ import annotations

from typing import Optional, Tuple

#: card figures from NVIDIA's data sheets: memory bytes/s and dense peak
#: operations/s for 16-bit and TF32 (tensor cores) and 32-bit float (CUDA
#: cores). The one table: the trainer's MFU and chip_smoke's bounds read it
DEVICE_SPECS = {
    "H100 PCIe": dict(bw=2.0e12, peak16=756e12, peak_tf32=378e12, peak32=51e12),
    "H100 NVL": dict(bw=3.9e12, peak16=835e12, peak_tf32=417.5e12, peak32=60e12),
    "H100 SXM": dict(bw=3.35e12, peak16=989e12, peak_tf32=495e12, peak32=67e12),
}


def card_figures(name: str) -> Optional[Tuple[str, dict]]:
    """(table key, figures) of a card by its ``torch.cuda.get_device_name``
    (an H100 that is neither PCIe nor NVL is the SXM), or None for another
    device."""
    if "H100" not in name:
        return None
    for key in ("H100 PCIe", "H100 NVL"):
        if key.split()[1] in name:
            return key, DEVICE_SPECS[key]
    return "H100 SXM", DEVICE_SPECS["H100 SXM"]


def flops_per_token(cfg, seq_len: Optional[int] = None) -> int:
    """Analytic train-step FLOPs a token (fwd + bwd) of ``cfg``."""
    t = cfg.context_length if seq_len is None else seq_len
    n_matmul = cfg.num_params(exclude_embeddings=True)
    attention = 12 * cfg.n_layers * cfg.emb_dim * t
    return 6 * n_matmul + attention


def device_peak_flops(device=None, dtype: str = "bf16") -> Optional[float]:
    """The dense peak FLOPs/s of one card for ``dtype`` ("fp32": the CUDA
    cores; a 16-bit dtype: the tensor cores), or None off the card or for
    a card the table does not hold."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    found = card_figures(torch.cuda.get_device_name(device))
    if found is None:
        return None
    return found[1]["peak32" if dtype == "fp32" else "peak16"]


def mfu_from_flops(tokens_per_s: float, flops_per_token: float,
                   n_devices: int = 1,
                   peak: Optional[float] = None) -> Optional[float]:
    """MFU of a throughput at ``flops_per_token``; None when the peak is
    unknown or the inputs are degenerate. ``tokens_per_s`` and
    ``n_devices`` describe the same scope (the trainer: one process, one
    card)."""
    if peak is None or tokens_per_s <= 0 or not flops_per_token:
        return None
    return tokens_per_s * flops_per_token / (peak * max(1, n_devices))


def compute_mfu(tokens_per_s: float, cfg, n_devices: int = 1,
                peak: Optional[float] = None, seq_len: Optional[int] = None,
                device=None, dtype: str = "bf16") -> Optional[float]:
    """MFU in [0, 1] of a measured throughput of ``cfg``, against ``peak``
    or the card's peak for ``dtype``; None off the card."""
    if peak is None:
        peak = device_peak_flops(device, dtype)
    return mfu_from_flops(tokens_per_s, flops_per_token(cfg, seq_len),
                          n_devices=n_devices, peak=peak)


def format_mfu(mfu: Optional[float]) -> str:
    """Log-line rendering: '41.4% MFU', or 'MFU n/a' off the card."""
    return "MFU n/a" if mfu is None else f"{100.0 * mfu:.1f}% MFU"
