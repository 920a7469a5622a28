"""The checkpoint formats of the JAX package's ``training/checkpoint.py``:
the parameter export (``export_params`` / ``load_exported_params``), the
train-state checkpoint (``save_checkpoint`` / ``load_checkpoint``), and
the weight carrier from a JAX parameter tree to the port's model.

Export format: one ``.npz`` with a key per leaf named by its tree path
(``blocks/attn/wq``), plus a ``__dtype__.<key>`` entry naming the dtype.
``np.savez`` stores bf16 leaves as raw 2-byte void records, so their bits
are reinterpreted, never converted: ``uint16 -> int16 -> torch.bfloat16``
keeps them bit-exact, both ways. ``lora_from_jax`` carries a LoRA adapter
tree across the same way.

Train-state checkpoint format (``"sharded-v1"``, the JAX package's, so
either package reads the other's): a directory with one ``.npy`` per leaf
(``leaf_00000.shard_000.npy``: on one process every leaf is one shard)
and a ``manifest.json`` listing each leaf's tree ``path``, ``shape``,
``dtype`` and its shard's ``index``, ``bytes`` and ``sha256``, plus the
run's ``metadata``. Leaves are written in the JAX tree's flattening order
(keys sorted at every level). bf16 leaves are 2-byte void records with
``"dtype": "bfloat16"`` in the manifest, restored by a view. A save stages
into ``<dir>.tmp`` and commits by renames (the previous checkpoint to
``<dir>.old``, the staging dir to ``<dir>``), so a reader never sees a
manifest without its shards; a save cut between the two renames leaves
two complete neighbours, which ``load_checkpoint`` falls back to.

Sharded states (``parallel.MeshPlan``, more than one rank): the tree holds
each rank's slices and ``layout`` maps their paths to
``MeshPlan.leaf_layout``'s (global shape, unique shards' indices in the
JAX save's order, the shard this rank writes or None, this rank's own
indices). Every rank writes the shards it owns, as the JAX processes do:
each unique shard once, by the lowest rank holding it (so the manifest's
indices are the JAX save's, on one mesh axis or two) and, from rank 0,
every replicated leaf. After a barrier rank 0 hashes the other ranks' files, writes the
manifest and commits; a second barrier holds every rank until the commit
is visible. A restore reads each rank's slice from whatever shards cover
it, so a checkpoint of one world size restores onto another.

A save is two halves (the JAX ``snapshot_for_save`` / ``write_snapshot``):
the snapshot copies every leaf to host memory (device leaves into pinned
buffers, on the current stream, so the copies are ordered before any
later in-place update of the state) and returns at once; the write waits
for those copies, then stages, hashes and commits. ``save_checkpoint`` is
the two in a row; ``training/async_checkpoint.py`` runs the write on a
worker thread. A committed save emits ``checkpoint_save``, a restore
``checkpoint_restore`` (the JAX events' fields).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from building_llm_from_scratch_tpu_torch.configs import ModelConfig
from building_llm_from_scratch_tpu_torch.device import resolve_device
from building_llm_from_scratch_tpu_torch.models.transformer import (
    Transformer,
    param_shapes,
)
from building_llm_from_scratch_tpu_torch.obs.metrics import emit_event
from building_llm_from_scratch_tpu_torch.parallel import collectives as coll

logger = logging.getLogger(__name__)

_NUMPY_NAMES = {"fp32": "float32", "fp16": "float16", "bf16": "bfloat16"}

_SHARDED_FORMAT = "sharded-v1"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}; a flat dict passes through."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def numpy_to_torch(arr: np.ndarray, dtype_name: str | None = None) -> torch.Tensor:
    """A numpy leaf as a CPU tensor, bit for bit. bf16 arrays (ml_dtypes, or
    the raw 2-byte records np.load gives back) are reinterpreted through
    int16, since torch has no numpy bf16. The tensor owns a copy of the
    data (``torch.tensor``), so its storage can be freed and grown again
    (``train_step.release_params``)."""
    arr = np.asarray(arr)
    name = dtype_name or arr.dtype.name
    if name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"bfloat16 leaf stored with itemsize {arr.dtype.itemsize}")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.tensor(bits).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        arr = arr.view(np.dtype(name))
    return torch.tensor(np.ascontiguousarray(arr))


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy leaf, bit for bit: bf16 becomes the 2-byte void
    records ``np.savez`` writes for a JAX bf16 array."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def export_params(path: str, params) -> str:
    """Write a model's parameters (a ``Transformer``, or its flat
    ``{"blocks/attn/wq": tensor}`` form, e.g. a LoRA run's merged weights)
    in the JAX ``export_params`` format: one key per JAX tree path (sorted,
    the tree's flattening order) and a ``__dtype__.<key>`` entry with the
    dtype's numpy name. The JAX package's ``load_exported_params`` and the
    port's read it back with identical bits."""
    flat = params.flat_params() if isinstance(params, Transformer) else params
    arrays = {}
    for key, t in sorted(flat.items()):
        arrays[key] = torch_to_numpy(t)
        arrays[f"__dtype__.{key}"] = np.asarray(
            "bfloat16" if t.dtype == torch.bfloat16
            else str(arrays[key].dtype))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    return path


def params_from_jax(tree_or_flat: Dict[str, Any], cfg: ModelConfig,
                    device: torch.device | str = "cuda") -> Transformer:
    """Build the port's model from a JAX parameter tree (nested dict of
    numpy arrays, e.g. ``jax.device_get(params)``) or its flat
    ``{"blocks/attn/wq": array}`` form. The layouts are the same, so no leaf
    is transposed; leaves keep their dtype."""
    device = resolve_device(device)
    flat = flatten_tree(tree_or_flat)
    return Transformer(cfg, {k: numpy_to_torch(v).to(device)
                             for k, v in flat.items()})


def load_exported_params(path: str, cfg: ModelConfig,
                         device: torch.device | str = "cuda") -> Transformer:
    """Load an ``export_params`` ``.npz`` into the port's model for ``cfg``.
    Each leaf is restored through its recorded dtype, then cast to the
    config's dtype, as the JAX loader casts to its template."""
    device = resolve_device(device)
    with np.load(path) as data:
        flat = {}
        for key in param_shapes(cfg):
            if key not in data:
                raise KeyError(f"Export missing parameter {key}")
            dkey = f"__dtype__.{key}"
            recorded = (str(data[dkey]) if dkey in data
                        else _NUMPY_NAMES[cfg.dtype])
            t = numpy_to_torch(data[key], recorded)
            flat[key] = t.to(device=device, dtype=cfg.torch_dtype)
    return Transformer(cfg, flat)


def lora_from_jax(tree_or_flat: Dict[str, Any], cfg: ModelConfig,
                  device: torch.device | str = "cuda") -> Dict[str, Any]:
    """The port's adapter tree (``models/lora.py``) from a JAX lora tree of
    numpy arrays (``jax.device_get(lora)``) or its flat ``{"blocks/attn/wq/A":
    array}`` form: the same nesting and layouts, no transposes, bit-exact
    (bf16 included). Every leaf's shape is checked against ``cfg`` at the
    adapter's rank."""
    from building_llm_from_scratch_tpu_torch.models.lora import (
        adapted_shapes,
        unflatten_lora,
    )

    device = resolve_device(device)
    flat = {tuple(k.split("/")): numpy_to_torch(v).to(device)
            for k, v in flatten_tree(tree_or_flat).items()}
    rank = next((leaf.shape[-1] for p, leaf in flat.items() if p[-1] == "A"), 0)
    expected = adapted_shapes(cfg, rank)
    if set(flat) != set(expected):
        raise KeyError(f"adapter differs from the config's: missing "
                       f"{sorted(set(expected) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(expected))}")
    for path, shape in expected.items():
        if tuple(flat[path].shape) != shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(flat[path].shape)} "
                             f"!= {shape}")
    return unflatten_lora(flat)


# ---------------------------------------------------------------------------
# train-state checkpoints (the JAX "sharded-v1" format)
# ---------------------------------------------------------------------------

def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return "bfloat16" if leaf.dtype == torch.bfloat16 else str(
            torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _tree_order(tree: Dict[str, Any]) -> list:
    """The flat tree's paths in the JAX flattening order: keys sorted at
    every level (the order of the paths' part tuples)."""
    return sorted(tree, key=lambda p: tuple(p.split("/")))


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    """Chunked file hash, shared by the save path (recording) and
    ``resilience.validate_checkpoint`` (verifying)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _write_shard_hashed(path: str, arr: np.ndarray):
    """``np.save`` ``arr`` to ``path`` and hash the file's bytes; returns
    (bytes, sha256). To a real file numpy writes the data in one call
    with the GIL released, and the hash takes the header read back and
    then the array's memory in one call (hashlib releases the GIL too), so
    a writer thread barely holds the GIL the step loop needs."""
    arr = np.require(arr, requirements="C")     # keeps 0-d arrays 0-d
    with open(path, "wb") as f:
        np.save(f, arr)
        size = f.tell()
    with open(path, "rb") as f:
        h = hashlib.sha256(f.read(size - arr.nbytes))
    h.update(arr.reshape(-1).view(np.uint8))
    return size, h.hexdigest()


def _host_leaf(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return torch_to_numpy(leaf)
    return np.asarray(leaf)


def snapshot_for_save(tree: Dict[str, Any],
                      extra_metadata: Optional[dict] = None) -> dict:
    """Everything ``write_snapshot`` needs, decoupled from the live state:
    the manifest (without the shards' sizes and hashes) and a host copy of
    every leaf of ``tree`` (flat JAX path -> tensor or numpy leaf, as
    ``train_step.checkpoint_tree`` builds it). A leaf on the card is copied
    into a pinned buffer without waiting; ``ready`` (a CUDA event on the
    current stream, None when nothing was copied from the card) marks the
    copies' end, and the stream orders them before the next step's
    in-place updates. The host holds the whole state while the snapshot
    lives, in pinned memory that torch's host allocator keeps for the
    next save."""
    manifest = {"format": _SHARDED_FORMAT, "leaves": [],
                "metadata": extra_metadata or {}}
    arrays: Dict[str, Any] = {}
    on_card = False
    for i, path in enumerate(_tree_order(tree)):
        leaf = tree[path]
        fname = f"leaf_{i:05d}.shard_000.npy"
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                on_card = True
            else:
                host = t.clone()
            shape = tuple(t.shape)
        else:
            host = np.array(leaf)
            shape = host.shape
        arrays[fname] = host
        manifest["leaves"].append({
            "index": i, "path": path, "shape": list(shape),
            "dtype": _dtype_name(leaf),
            "shards": [{"file": fname, "index": [[0, d] for d in shape]}]})
    ready = None
    if on_card:
        ready = torch.cuda.Event()
        ready.record()
    return {"manifest": manifest, "arrays": arrays, "ready": ready}


def write_snapshot(ckpt_dir: str, snapshot: dict) -> dict:
    """Write a ``snapshot_for_save`` snapshot as a committed checkpoint at
    ``ckpt_dir``: wait for its copies, stage and hash every leaf into
    ``<dir>.tmp``, the manifest last, then commit by renames. Host
    work only, so it may run on a worker thread. Returns what was written:
    ``path``, ``bytes``, ``leaves`` and ``seconds``."""
    t0 = time.perf_counter()
    if snapshot["ready"] is not None:
        snapshot["ready"].synchronize()
    manifest, arrays = snapshot["manifest"], snapshot["arrays"]
    ckpt_dir = ckpt_dir.rstrip("/")
    tmp_dir = ckpt_dir + ".tmp"
    if os.path.isdir(tmp_dir):
        # a crashed earlier save may have left a stale staging dir
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    for leaf in manifest["leaves"]:
        for sh in leaf["shards"]:
            sh["bytes"], sh["sha256"] = _write_shard_hashed(
                os.path.join(tmp_dir, sh["file"]), _host_leaf(arrays[sh["file"]]))
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _commit(ckpt_dir, tmp_dir)
    return dict(path=ckpt_dir, leaves=len(manifest["leaves"]),
                bytes=sum(sh["bytes"] for leaf in manifest["leaves"]
                          for sh in leaf["shards"]),
                seconds=time.perf_counter() - t0)


def save_checkpoint(ckpt_dir: str, tree: Dict[str, Any],
                    extra_metadata: Optional[dict] = None,
                    layout: Optional[Dict[str, tuple]] = None) -> dict:
    """Write ``tree`` (flat JAX path -> tensor or numpy leaf, as
    ``train_step.checkpoint_tree`` builds it) as a committed ``sharded-v1``
    checkpoint at ``ckpt_dir``: the snapshot, then the write. Returns what
    was written: ``path``, ``bytes``, ``leaves`` and ``seconds`` (both
    halves). With more than one rank every rank calls it (``layout``:
    ``train_step.checkpoint_layout``; module docstring) and ``bytes`` is
    the whole checkpoint's on rank 0, the rank's own elsewhere."""
    t0 = time.perf_counter()
    if coll.world() > 1:
        info = _save_ranks(ckpt_dir, tree, extra_metadata, layout or {})
    else:
        info = write_snapshot(ckpt_dir, snapshot_for_save(tree, extra_metadata))
    info["seconds"] = time.perf_counter() - t0
    emit_checkpoint_save(info, extra_metadata)
    return info


def emit_checkpoint_save(info: dict, extra_metadata: Optional[dict],
                         writer: Optional[str] = None) -> None:
    """The ``checkpoint_save`` event of one committed write (``writer``
    "async" from the asynchronous writer)."""
    fields = dict(path=info["path"], step=(extra_metadata or {}).get("global_step"),
                  seconds=round(info["seconds"], 4), bytes=info["bytes"],
                  leaves=info["leaves"])
    if writer is not None:
        fields["writer"] = writer
    emit_event("checkpoint_save", **fields)


def _save_ranks(ckpt_dir: str, tree: Dict[str, Any],
                extra_metadata: Optional[dict], layout: Dict[str, tuple]) -> dict:
    """The multi-rank save (module docstring): owned shards from every
    rank, then rank 0's hashes, manifest and commit, between barriers."""
    rank = coll.rank()
    ckpt_dir = ckpt_dir.rstrip("/")
    tmp_dir = ckpt_dir + ".tmp"
    if rank == 0:
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
    coll.sync_global_devices("ckpt_stage")
    manifest = {"format": _SHARDED_FORMAT, "leaves": [],
                "metadata": extra_metadata or {}}
    written: Dict[str, tuple] = {}
    for i, path in enumerate(_tree_order(tree)):
        leaf = tree[path]
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
        whole = [[0, int(d)] for d in shape]
        gshape, bounds, mine, _ = layout.get(
            path, (shape, [whole], 0 if rank == 0 else None, whole))
        shards = [{"file": f"leaf_{i:05d}.shard_{k:03d}.npy", "index": b}
                  for k, b in enumerate(bounds)]
        if mine is not None:
            fname = shards[mine]["file"]
            written[fname] = _write_shard_hashed(os.path.join(tmp_dir, fname),
                                                 _host_leaf(leaf))
        manifest["leaves"].append({"index": i, "path": path,
                                   "shape": list(gshape),
                                   "dtype": _dtype_name(leaf), "shards": shards})
    coll.sync_global_devices("ckpt_shards")
    total = sum(b for b, _ in written.values())
    if rank == 0:
        for leaf in manifest["leaves"]:
            for sh in leaf["shards"]:
                if sh["file"] in written:
                    sh["bytes"], sh["sha256"] = written[sh["file"]]
                else:
                    spath = os.path.join(tmp_dir, sh["file"])
                    sh["bytes"], sh["sha256"] = os.path.getsize(spath), sha256_file(spath)
        total = sum(sh["bytes"] for leaf in manifest["leaves"]
                    for sh in leaf["shards"])
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        _commit(ckpt_dir, tmp_dir)
    coll.sync_global_devices("ckpt_commit")
    return dict(path=ckpt_dir, leaves=len(manifest["leaves"]), bytes=total)


def _commit(ckpt_dir: str, tmp_dir: str) -> None:
    """The two-rename commit: the previous checkpoint to ``.old``, the
    staging dir to ``ckpt_dir``, then ``.old`` removed."""
    old_dir = None
    if os.path.isdir(ckpt_dir):
        old_dir = ckpt_dir + ".old"
        if os.path.isdir(old_dir):
            shutil.rmtree(old_dir)
        os.rename(ckpt_dir, old_dir)
    os.rename(tmp_dir, ckpt_dir)
    if old_dir is not None:
        shutil.rmtree(old_dir)


def _resolve_ckpt_dir(ckpt_dir: str) -> str:
    """A checkpoint tag -> a readable dir, recovering from a save cut inside
    its two-rename commit: the tag itself, else its completed staging dir
    (``.tmp``: its manifest is written last), else the displaced previous
    checkpoint (``.old``)."""
    if os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
        return ckpt_dir
    for suffix in (".tmp", ".old"):
        cand = ckpt_dir.rstrip("/") + suffix
        if os.path.exists(os.path.join(cand, "manifest.json")):
            logger.warning(
                "Checkpoint %s has no manifest (save cut mid-commit?); "
                "recovering from %s", ckpt_dir, cand)
            return cand
    return ckpt_dir


def _cleanup_stale_siblings(ckpt_dir: str) -> None:
    """Remove the ``.tmp``/``.old`` staging dirs a crashed save left; only
    called once the tag itself resolved, so they are leftovers. Rank 0
    only."""
    if not coll.is_coordinator():
        return
    for suffix in (".tmp", ".old"):
        cand = ckpt_dir.rstrip("/") + suffix
        if os.path.isdir(cand):
            logger.warning("Removing orphaned checkpoint staging dir %s (left "
                           "by a crashed save).", cand)
            shutil.rmtree(cand, ignore_errors=True)


def _read_manifest(ckpt_dir: str) -> dict:
    """Read and structurally check a manifest, raising one clear
    ``ValueError`` naming the dir and what is missing or malformed."""
    manifest_path = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.isfile(manifest_path):
        raise ValueError(
            f"'{ckpt_dir}' is not a readable checkpoint: manifest.json is "
            "missing (not a checkpoint directory, or the save died before "
            "its commit and left no recoverable .tmp/.old staging dir).")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise ValueError(
            f"Checkpoint manifest {manifest_path} is malformed "
            f"({type(e).__name__}: {e}); the checkpoint cannot be "
            "restored.") from e
    if not isinstance(manifest, dict) or not isinstance(
            manifest.get("leaves"), list):
        raise ValueError(
            f"Checkpoint manifest {manifest_path} is malformed: expected a "
            "JSON object with a 'leaves' list.")
    return manifest


def _read_leaf(ckpt_dir: str, meta: dict) -> np.ndarray:
    """A leaf's whole array from its shard files (a JAX checkpoint written
    from a sharded state holds a leaf in several)."""
    shape = tuple(meta["shape"])
    out = None
    for sh in meta["shards"]:
        arr = np.load(os.path.join(ckpt_dir, sh["file"]))
        if [list(map(int, b)) for b in sh["index"]] == [[0, d] for d in shape]:
            return arr
        if out is None:
            out = np.empty(shape, arr.dtype)
        out[tuple(slice(a, b) for a, b in sh["index"])] = arr
    if out is None:
        raise ValueError(f"Checkpoint leaf '{meta['path']}' has no shard files")
    return out


def _read_leaf_slice(ckpt_dir: str, meta: dict, bounds: list) -> np.ndarray:
    """The box ``bounds`` ([start, stop] per dimension) of a leaf, from the
    shard files that overlap it (memory-mapped: only the covered bytes are
    read)."""
    for sh in meta["shards"]:
        if [list(map(int, b)) for b in sh["index"]] == bounds:
            return np.load(os.path.join(ckpt_dir, sh["file"]))
    out, filled = None, 0
    for sh in meta["shards"]:
        lo = [max(a[0], b[0]) for a, b in zip(sh["index"], bounds)]
        hi = [min(a[1], b[1]) for a, b in zip(sh["index"], bounds)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        src = np.load(os.path.join(ckpt_dir, sh["file"]), mmap_mode="r")
        part = np.asarray(src[tuple(slice(l - s[0], h - s[0])
                                    for l, h, s in zip(lo, hi, sh["index"]))])
        if out is None:
            out = np.empty([b[1] - b[0] for b in bounds], part.dtype)
        out[tuple(slice(l - b[0], h - b[0]) for l, h, b in zip(lo, hi, bounds))] = part
        filled += part.size
    if out is None or filled < out.size:
        raise ValueError(f"Checkpoint shards of leaf '{meta['path']}' do not "
                         f"cover {bounds}: an incomplete checkpoint?")
    return out


def load_checkpoint(ckpt_dir: str, template: Dict[str, Any],
                    layout: Optional[Dict[str, tuple]] = None) -> Dict[str, Any]:
    """Restore a ``sharded-v1`` checkpoint (of either package) into the
    structure of ``template`` (flat JAX path -> tensor or numpy leaf, as
    ``train_step.checkpoint_tree`` builds it). Paths, shapes and dtypes are
    checked against the manifest. A tensor leaf is refilled in place (its
    storage, and every view of it, sees the checkpoint's values); a numpy
    leaf is returned as the array read. The ``rng`` leaf (a JAX PRNG key,
    whose shape depends on the key implementation) keeps the template's
    value when the shapes differ. ``layout`` (a sharded state's
    ``train_step.checkpoint_layout``): its leaves are this rank's slices of
    the global shapes it names, read from whatever shards cover them.
    Returns {path: restored leaf}."""
    t_load = time.perf_counter()
    resolved = _resolve_ckpt_dir(ckpt_dir)
    if resolved == ckpt_dir:
        _cleanup_stale_siblings(ckpt_dir)
    ckpt_dir = resolved
    manifest = _read_manifest(ckpt_dir)
    order = _tree_order(template)
    if len(order) != len(manifest["leaves"]):
        raise ValueError(
            f"Checkpoint has {len(manifest['leaves'])} leaves but template "
            f"state has {len(order)} — structure mismatch.")
    out: Dict[str, Any] = {}
    for path, meta in zip(order, manifest["leaves"]):
        tmpl = template[path]
        if path != meta["path"]:
            raise ValueError(f"Leaf path mismatch: template {path} vs "
                             f"checkpoint {meta['path']}")
        shape = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) else np.shape(tmpl)
        entry = (layout or {}).get(path)
        gshape = shape if entry is None else entry[0]
        if tuple(meta["shape"]) != tuple(gshape):
            if path == "rng":
                logger.warning("Checkpoint rng leaf has shape %s, the template "
                               "%s; keeping the template's.",
                               tuple(meta["shape"]), tuple(shape))
                out[path] = tmpl
                continue
            raise ValueError(
                f"Checkpoint leaf '{meta['path']}' has shape "
                f"{tuple(meta['shape'])} but the model expects {tuple(gshape)} "
                "— wrong model size/config for this checkpoint.")
        if meta["dtype"] != _dtype_name(tmpl):
            raise ValueError(
                f"Checkpoint leaf '{meta['path']}' has dtype "
                f"{meta['dtype']} but the model expects {_dtype_name(tmpl)} "
                "— was the checkpoint written with a different --data_type?")
        if entry is None:
            arr = _read_leaf(ckpt_dir, meta)
        else:
            arr = _read_leaf_slice(ckpt_dir, meta, entry[3])
        if isinstance(tmpl, torch.Tensor):
            with torch.no_grad():
                tmpl.copy_(numpy_to_torch(arr, meta["dtype"]))
            out[path] = tmpl
        else:
            out[path] = np.asarray(arr).view(np.dtype(meta["dtype"]))
    emit_event("checkpoint_restore", path=ckpt_dir,
               step=manifest.get("metadata", {}).get("global_step"),
               seconds=round(time.perf_counter() - t_load, 4),
               leaves=len(manifest["leaves"]))
    return out


def checkpoint_metadata(ckpt_dir: str) -> dict:
    """The ``metadata`` of a checkpoint's manifest."""
    return _read_manifest(_resolve_ckpt_dir(ckpt_dir)).get("metadata", {})


def leaf_dtypes(ckpt_dir: str) -> Dict[str, str]:
    """Tree path -> dtype name of every leaf in a checkpoint's manifest."""
    manifest = _read_manifest(_resolve_ckpt_dir(ckpt_dir))
    return {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}
