"""Host-side file IO helpers (the port's copy of the JAX package's
``utils/io.py``)."""

from __future__ import annotations

import os
from typing import List, Tuple


def read_text_file(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def discover_training_files(data_dir: str) -> Tuple[List[str], List[str]]:
    """Walk ``data_dir`` collecting .txt (pretrain) and .json (finetune)
    files. Returns (txt_files, json_files), both sorted for determinism."""
    txt, js = [], []
    for root, _dirs, files in os.walk(data_dir):
        for fname in files:
            p = os.path.join(root, fname)
            if fname.endswith(".txt"):
                txt.append(p)
            elif fname.endswith(".json"):
                js.append(p)
    return sorted(txt), sorted(js)
