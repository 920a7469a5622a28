"""Per-layer-group training health (port of the JAX package's
``obs/health.py``).

The global pre-clip ``grad_norm`` says that something went wrong, never
where. This module computes the localized view inside the train step:
per-group gradient norms (pre-clip), parameter norms (after the update),
update norms (post-clip: the clip comes first in the optimizer), the
update-to-parameter ratios and the first group holding a non-finite
gradient, as small ``(n_groups,)`` tensors in the step's metrics. They
stay on the device: the trainer appends them each step and fetches them
at its logging cadence only.

Groups: the sorted top-level names of the flat trees (``tok_emb``,
``blocks``, ``head``, ...; a LoRA adapter's ``blocks`` and ``head``), with
the stacked ``blocks`` leaves (leading layer axis) expanded to
``block_00..block_{L-1}``. The sums of a tree's leaves, a stacked leaf's
layer by layer, come from one fused reduction (``torch._foreach_norm``),
never one launch a layer. Sums are fp32 on the device: a 16-bit leaf is
read in place and accumulated in fp32, never copied to fp32.

A sharded step holds slices of some leaves (``GroupSums``): each leaf's
per-group partial sums land in the vector of the mesh axes it is split
on, the vectors are all-reduced once an axis (every tree's in one
stacked call), and a leaf replicated along an axis is counted once. A
pipeline stage's block leaves hold the layers ``layer0..`` only: their
sums are placed there before the stage axis sums them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: top-level name whose leaves carry a stacked leading layer axis
STACKED_KEY = "blocks"

#: per-group arrays of the bundle (each a (n_groups,) fp32 tensor)
HEALTH_ARRAYS = ("grad_norm", "param_norm", "update_norm", "update_ratio")

Flat = Dict[str, torch.Tensor]


def _top(key: str) -> str:
    return key.split("/", 1)[0]


def _stacked_len(tree: Flat) -> int:
    """Leading-axis length of the stacked leaves (the layer count), or 0."""
    for k, v in tree.items():
        if _top(k) == STACKED_KEY:
            return int(v.shape[0])
    return 0


def group_names(tree: Flat, n_layers: Optional[int] = None) -> List[str]:
    """Ordered group labels of a flat tree: its sorted top-level names,
    ``blocks`` expanded to ``block_00..`` (``n_layers``: the whole model's
    layer count where ``tree`` holds one pipeline stage's)."""
    names: List[str] = []
    for top in sorted({_top(k) for k in tree}):
        if top == STACKED_KEY:
            L = _stacked_len(tree) if n_layers is None else n_layers
            names.extend(f"block_{i:02d}" for i in range(L))
        else:
            names.append(top)
    return names


def _leaf_rows(tree: Flat, keys) -> List[Tuple[str, torch.Tensor]]:
    """(top-level name, leaf) in sorted key order, detached: the order of
    the per-row vectors below (a stacked leaf gives one row a layer)."""
    return [(_top(k), tree[k].detach()) for k in sorted(keys)]


def _row_sumsq(rows) -> torch.Tensor:
    """fp32 sums of squares, one per layer of each stacked leaf and one
    per other leaf, in one fused reduction over the whole list
    (``torch._foreach_norm`` reads 16-bit leaves in place, accumulating in
    fp32)."""
    tensors: List[torch.Tensor] = []
    for top, x in rows:
        tensors.extend(x.unbind(0) if top == STACKED_KEY else (x,))
    return torch.stack(torch._foreach_norm(tensors, 2, dtype=torch.float32)).square()


def _row_nonfinite(rows) -> torch.Tensor:
    """Any non-finite element, one flag per row of ``_row_sumsq``, read off
    the leaves (a sum of squares can overflow on its own): each row's min
    and max, which a NaN or an inf reaches."""
    los, his = [], []
    for top, x in rows:
        lo, hi = torch.aminmax(x.reshape(x.shape[0] if top == STACKED_KEY else 1, -1),
                               dim=1)
        los.append(lo)
        his.append(hi)
    finite = torch.isfinite(torch.cat(los + his))
    n = finite.shape[0] // 2
    return ~(finite[:n] & finite[n:])


class GroupLayout:
    """The (G,) vector's layout: the sorted top-level names (``blocks``
    taking ``n_layers`` entries, the whole model's layers), and ``layer0``,
    the first layer a stage's block leaves hold (0 but under pp)."""

    def __init__(self, keys: Sequence[str], n_layers: int, layer0: int = 0):
        self.n_layers, self.layer0 = int(n_layers), int(layer0)
        self.tops = sorted({_top(k) for k in keys})
        self.size = sum(self.n_layers if t == STACKED_KEY else 1 for t in self.tops)

    @classmethod
    def of(cls, tree: Flat) -> "GroupLayout":
        return cls(list(tree), _stacked_len(tree))

    def vector(self, parts: Dict[str, torch.Tensor], like: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
        """The (G,) vector of per-name parts ((1,) or a stage's (L_s,)),
        zeros where a name has no part."""
        pieces = []
        for top in self.tops:
            n = self.n_layers if top == STACKED_KEY else 1
            v = parts.get(top)
            if v is None:
                pieces.append(torch.zeros(n, dtype=dtype, device=like.device))
            elif v.shape[0] != n:
                # a stage's layers: zeros around them, the stage axis sums
                pieces.append(torch.nn.functional.pad(
                    v.to(dtype), (self.layer0, n - self.layer0 - v.shape[0])))
            else:
                pieces.append(v.to(dtype))
        return torch.cat(pieces)


def _parts(rows, per_row: torch.Tensor, combine: Callable) -> Dict[str, torch.Tensor]:
    """Per-row values summed (or or-ed) into each top-level name's part."""
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for top, x in rows:
        n = x.shape[0] if top == STACKED_KEY else 1
        v = per_row[pos:pos + n]
        pos += n
        out[top] = v if top not in out else combine(out[top], v)
    return out


def _group_sumsq(tree: Flat, layout: Optional[GroupLayout] = None) -> torch.Tensor:
    """(G,) fp32 sums of squares in ``group_names`` order."""
    layout = layout or GroupLayout.of(tree)
    rows = _leaf_rows(tree, tree)
    return layout.vector(_parts(rows, _row_sumsq(rows), torch.add), rows[0][1])


def _group_nonfinite(tree: Flat, layout: Optional[GroupLayout] = None
                     ) -> torch.Tensor:
    """(G,) bool: any non-finite element in the group."""
    layout = layout or GroupLayout.of(tree)
    rows = _leaf_rows(tree, tree)
    return layout.vector(_parts(rows, _row_nonfinite(rows), torch.logical_or),
                         rows[0][1]) > 0


def group_norms(tree: Flat) -> torch.Tensor:
    """(G,) fp32 L2 norms per group, in ``group_names`` order."""
    return _group_sumsq(tree).sqrt()


def _first_index(bad: torch.Tensor) -> torch.Tensor:
    if bad.shape[0] == 0:
        return torch.tensor(-1, dtype=torch.int32, device=bad.device)
    idx = bad.to(torch.int32).argmax().to(torch.int32)
    return torch.where(bad.any(), idx, torch.full_like(idx, -1))


def first_nonfinite_group(tree: Flat) -> torch.Tensor:
    """Index (int32 0-d tensor) of the first group holding a non-finite
    value, or -1 when every group is finite."""
    return _first_index(_group_nonfinite(tree))


def _bundle(g: torch.Tensor, p: torch.Tensor, u: torch.Tensor,
            bad: torch.Tensor) -> Dict[str, torch.Tensor]:
    g, p, u = g.sqrt(), p.sqrt(), u.sqrt()
    return {"grad_norm": g, "param_norm": p, "update_norm": u,
            "update_ratio": u / p.clamp_min(1e-12),
            "first_nonfinite": _first_index(bad)}


def group_health(grads: Flat, params: Flat, updates: Flat
                 ) -> Dict[str, torch.Tensor]:
    """The health bundle of one optimizer step: ``grads`` pre-clip,
    ``params`` after the update, ``updates`` what was added to them
    (post-clip, post-Adam, post-LR). (G,) fp32 ``grad_norm`` /
    ``param_norm`` / ``update_norm``, ``update_ratio`` = update over param
    norm (0-norm groups report 0) and ``first_nonfinite`` (int32, -1 when
    healthy)."""
    sums = GroupSums(GroupLayout.of(grads))
    for kind, tree in (("grad", grads), ("param", params), ("update", updates)):
        sums.add(kind, tree)
    return sums.bundle()


class GroupSums:
    """The health bundle of a sharded step (module docstring). ``splits``
    is the step's ((mesh axis, {leaf: split dim or None}), ...) for the
    parameters and gradients, ``moment_splits`` for the updates (zero1
    updates a data shard of whole parameters); ``reduce(t, axis)`` sums
    over the rank's line of ``axis``. ``add`` may run while the leaves are
    still the ones named (the gradients before the clip scales them in
    place); ``bundle`` makes the collectives."""

    def __init__(self, layout: GroupLayout, splits: tuple = (),
                 moment_splits: Optional[tuple] = None,
                 reduce: Optional[Callable] = None):
        self.layout = layout
        self.splits = {"grad": splits, "param": splits,
                       "update": splits if moment_splits is None else moment_splits}
        self.reduce = reduce
        #: (tree kind, scope) -> (G,) fp32 partial sums
        self.rows: Dict[Tuple[str, tuple], torch.Tensor] = {}

    def _scopes(self, kind: str, tree: Flat) -> Dict[tuple, List[str]]:
        out: Dict[tuple, List[str]] = {}
        for k in tree:
            scope = tuple(axis for axis, where in self.splits[kind]
                          if where.get(k) is not None)
            out.setdefault(scope, []).append(k)
        return out

    def add(self, kind: str, tree: Flat) -> None:
        """The partial sums of ``tree`` ("grad", "param" or "update"); the
        gradients add their non-finite flags too."""
        with torch.profiler.record_function("health"):
            self._add(kind, tree)

    def _add(self, kind: str, tree: Flat) -> None:
        for scope, keys in self._scopes(kind, tree).items():
            rows = _leaf_rows(tree, keys)
            like = rows[0][1]
            self.rows[(kind, scope)] = self.layout.vector(
                _parts(rows, _row_sumsq(rows), torch.add), like)
            if kind == "grad":
                self.rows[("bad", scope)] = self.layout.vector(
                    _parts(rows, _row_nonfinite(rows), torch.logical_or), like)

    def bundle(self) -> Dict[str, torch.Tensor]:
        """The whole bundle, on every rank: one stacked all-reduce for each
        mesh axis some leaf is split on."""
        with torch.profiler.record_function("health"):
            return self._bundle()

    def _bundle(self) -> Dict[str, torch.Tensor]:
        axes: List[str] = []
        for _kind, scope in self.rows:
            axes.extend(a for a in scope if a not in axes)
        for axis in axes:
            keys = [key for key in self.rows if axis in key[1]]
            out = self.reduce(torch.stack([self.rows[key] for key in keys]), axis)
            for j, key in enumerate(keys):
                self.rows[key] = out[j]
        total = {}
        for (kind, _scope), v in self.rows.items():
            total[kind] = v if kind not in total else total[kind] + v
        zeros = torch.zeros(self.layout.size, device=total["grad"].device)
        return _bundle(total["grad"], total.get("param", zeros),
                       total.get("update", zeros), total["bad"] > 0)


def nonfinite_group_name(names: List[str], fetched: Dict[str, Any]):
    """A fetched bundle's ``first_nonfinite`` index as its group name (None
    when healthy or out of range): the one place the -1 convention lives,
    shared by the health row and the watchdog context."""
    import numpy as np

    idx = int(np.asarray(fetched.get("first_nonfinite", -1)))
    return names[idx] if 0 <= idx < len(names) else None


def describe_health(names: List[str], fetched: Dict[str, Any],
                    top_k: int = 3) -> Dict[str, Any]:
    """Host digest of one fetched bundle for the ``watchdog_halt`` event:
    the first non-finite group (if any) and the ``top_k`` groups by
    gradient norm, so a halt says which layer."""
    import numpy as np

    out: Dict[str, Any] = {}
    out["first_nonfinite_group"] = nonfinite_group_name(names, fetched)
    gn = np.asarray(fetched.get("grad_norm", []), dtype=np.float64)
    if gn.size and len(names) == gn.size:
        order = np.argsort(gn)[::-1][:top_k]
        out["top_grad_norm_groups"] = [
            {"group": names[int(i)], "grad_norm": round(float(gn[int(i)]), 6)}
            for i in order]
    return out


def health_summary_line(names: List[str], fetched: Dict[str, Any]) -> str:
    """One log line: 'health: max grad block_07 1.2e+01, max ratio head
    3.1e-03'."""
    import numpy as np

    gn = np.asarray(fetched.get("grad_norm", []), dtype=np.float64)
    ur = np.asarray(fetched.get("update_ratio", []), dtype=np.float64)
    if not gn.size or len(names) != gn.size:
        return "health: n/a"
    gi = int(np.argmax(gn))
    line = f"health: max grad {names[gi]} {gn[gi]:.2e}"
    if ur.size == gn.size:
        ri = int(np.argmax(ur))
        line += f", max ratio {names[ri]} {ur[ri]:.2e}"
    return line


def fetch_health(bundle: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A bundle's tensors as host numpy arrays (the cadence's fetch)."""
    return {k: v.detach().cpu().numpy() for k, v in bundle.items()}
