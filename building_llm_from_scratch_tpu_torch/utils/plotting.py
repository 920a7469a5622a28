"""The loss plot, ``losses.pdf`` (the port's copy of the JAX package's
``utils/plotting.py``). matplotlib is imported when a plot is drawn, not
when this module is."""

from __future__ import annotations

import os
from typing import Sequence


def plot_losses(epochs_seen: Sequence[float], tokens_seen: Sequence[int],
                train_losses: Sequence[float], val_losses: Sequence[float],
                output_dir: str, filename: str = "losses.pdf") -> str:
    """Train and validation loss against epochs (bottom axis) and tokens
    seen (top axis), written to ``output_dir/filename``; returns the
    path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots()
    ax1.plot(epochs_seen, train_losses, label="Training loss")
    ax1.plot(epochs_seen, val_losses, linestyle="-.", label="Validation loss")
    ax1.set_xlabel("Epochs")
    ax1.set_ylabel("Loss")
    ax1.legend(loc="upper right")

    ax2 = ax1.twiny()
    ax2.plot(tokens_seen, train_losses, alpha=0)  # align the top axis to tokens
    ax2.set_xlabel("Tokens seen")

    fig.tight_layout()
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, filename)
    plt.savefig(out)
    plt.close(fig)
    return out
