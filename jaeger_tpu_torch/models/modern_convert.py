"""Copy of the parts of `jaeger_tpu/models/modern_convert.py` that the
legacy ``experimental_*`` converter reaches.

Reads Keras ``.h5`` weight files **without TensorFlow or Keras**
(:func:`read_keras_weight_groups`; ``h5py`` is imported inside it) and
maps their variable groups onto a flax variable tree of numpy arrays
(:func:`map_weights_to_tree`): slots (one per module, leaves in the
canonical Keras order) match groups on the ordered shape signature, then
on layer-name token overlap, then on the Keras creation ordinal. The tree
can come from the port's own modules
(:func:`jaeger_tpu_torch.models.legacy.variables_from_state`).
``convert_modern_weights`` (``utils convert-weights``) is not ported yet
(ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path

import numpy as np

logger = logging.getLogger("jaeger_tpu_torch")

# h5 paths that belong to training state, not model weights
_SKIP_TOKENS = ("optimizer", "metrics", "iteration", "_loss",
                "loss_scale")

# canonical within-layer variable order (Keras creation order)
_KEY_RANK = {
    "kernel": 0, "embedding": 0, "embeddings": 0, "alpha": 0,
    "pos_encoding": 0,
    "bias": 5,
    "gamma": 10, "scale": 10,
    "beta": 11,
    "moving_mean": 20, "mean": 20,
    "moving_variance": 21, "var": 21,
    # BiLSTM leaf order = Keras Bidirectional serialization order:
    # forward cell (kernel, recurrent, bias) then backward cell
    "fwd_kernel": 0, "fwd_recurrent": 1, "fwd_bias": 2,
    "bwd_kernel": 3, "bwd_recurrent": 4, "bwd_bias": 5,
}


def read_keras_weight_groups(h5_path: str | Path):
    """Read every per-layer variable group from a Keras weights file.

    Returns ``[(group_path, [np.ndarray, ...]), ...]``.  Handles both
    the Keras-3 object-tree layout (datasets named ``0``, ``1``, ...
    inside ``vars`` groups) and the legacy TF-Keras layout (datasets
    named ``kernel:0`` etc. inside named layer groups).
    """
    import h5py

    groups: list[tuple[str, list[np.ndarray]]] = []

    def is_skipped(path: str) -> bool:
        low = path.lower()
        return any(tok in low for tok in _SKIP_TOKENS)

    def walk(group, prefix: str):
        datasets = {k: v for k, v in group.items()
                    if isinstance(v, h5py.Dataset)}
        if datasets and not is_skipped(prefix):
            if all(re.fullmatch(r"\d+", k) for k in datasets):
                # Keras-3 "vars" group: numeric creation order
                order = sorted(datasets, key=int)
            else:
                # legacy layout: strip ":0", order by canonical key rank
                def rank(k: str):
                    base = k.removesuffix(":0").split("/")[-1]
                    return (_KEY_RANK.get(base, 50), k)
                order = sorted(datasets, key=rank)
            arrays = [np.asarray(datasets[k]) for k in order]
            path = prefix.strip("/")
            # legacy files nest layer/layer/weight; keras-3 ends in /vars
            groups.append((path, arrays))
        for k, v in group.items():
            if not isinstance(v, h5py.Dataset):
                walk(v, f"{prefix}/{k}")

    with h5py.File(h5_path, "r") as f:
        walk(f, "")
    groups = [g for g in groups if g[1]]
    return _merge_bidirectional_cells(groups)


def _merge_bidirectional_cells(groups):
    """Collapse Keras Bidirectional-LSTM cell groups into one group.

    Keras serializes an LSTM wrapper as two nested cells
    (``<lstm>/.../forward_layer/cell/vars`` + ``backward_layer/cell``),
    while the flax MaskedBiLSTM is a single module with fwd_*/bwd_*
    leaves — merge forward then backward arrays under the wrapper path
    (forward-first matches the fwd_*/bwd_* leaf ranks)."""
    fwd = {}
    bwd = {}
    rest = []
    order: list[str] = []
    for path, arrays in groups:
        if "/forward_layer/cell" in path:
            root = path.split("/forward_layer/cell")[0]
            fwd[root] = arrays
            if root not in order:
                order.append(root)
        elif "/backward_layer/cell" in path:
            root = path.split("/backward_layer/cell")[0]
            bwd[root] = arrays
            if root not in order:
                order.append(root)
        else:
            rest.append((path, arrays))
    for root in order:
        if root in fwd and root in bwd:
            rest.append((root, fwd[root] + bwd[root]))
        else:  # unidirectional wrapper: keep whichever side exists
            rest.append((root, fwd.get(root) or bwd.get(root)))
    return rest


def _tree_slots(variables: dict):
    """Flatten a JaegerModel variables tree into matchable slots.

    A *slot* is one flax sub-module: ``(path_tuple, [(collection, key)],
    [shape, ...])`` with leaves in canonical Keras order (batch_stats
    appended after params, matching Keras's trainable-then-nontrainable
    serialization).
    """
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})

    slots = []
    seen_paths = set()

    def leaf_dict(d):
        return d and all(hasattr(v, "shape") for v in d.values())

    def walk(pd, path):
        # direct array leaves at this level (a module may hold leaf
        # params AND sub-modules — e.g. HyenaFilter's alphas/biases next
        # to its FFN Dense children; skipping mixed dicts silently
        # dropped those leaves, found against a real reference file)
        direct = {k: v for k, v in pd.items() if hasattr(v, "shape")}
        if direct:
            seen_paths.add(path)
            if set(direct) == {"scale", "bias"}:
                # flax nn.BatchNorm/nn.LayerNorm: scale=gamma, bias=beta —
                # the generic rank (bias first, as in conv/dense) would
                # swap them against Keras's gamma-then-beta order
                keys = ["scale", "bias"]
            else:
                keys = sorted(direct,
                              key=lambda k: (_KEY_RANK.get(k, 50), k))
            leaves = [("params", k) for k in keys]
            sd = stats
            for p in path:
                sd = sd.get(p, {}) if isinstance(sd, dict) else {}
            if leaf_dict(sd):
                skeys = sorted(sd, key=lambda k: (_KEY_RANK.get(k, 50), k))
                leaves += [("batch_stats", k) for k in skeys]
            shapes = []
            for coll, k in leaves:
                src = direct if coll == "params" else sd
                shapes.append(tuple(src[k].shape))
            slots.append((path, leaves, shapes))
        for k, v in pd.items():
            if isinstance(v, dict):
                walk(v, path + (k,))

    walk(params, ())

    # modules that exist ONLY in batch_stats (e.g. NMDLayer's moving
    # mean) have no params leaf-dict and would otherwise be skipped —
    # Keras still serializes their variables as a group
    def walk_stats(sd, path):
        if leaf_dict(sd):
            if path in seen_paths:
                return
            keys = sorted(sd, key=lambda k: (_KEY_RANK.get(k, 50), k))
            slots.append((
                path,
                [("batch_stats", k) for k in keys],
                [tuple(sd[k].shape) for k in keys],
            ))
            return
        for k, v in sd.items():
            if isinstance(v, dict):
                walk_stats(v, path + (k,))

    walk_stats(stats, ())
    return _merge_multiscale_branches(slots)


def _merge_multiscale_branches(slots):
    """Merge per-branch conv slots of a MultiScaleConv1D into one slot.

    Keras serializes the reference MultiScaleConv1D as ONE variable
    group (branch kernels/biases in creation order) while our flax
    module nests a MaskedConv1D per branch — merge ``branch_<i>``
    sub-slots under their ``multi_scale*`` parent, branch order
    preserved."""
    merged: dict[tuple, list] = {}
    out = []
    for path, leaves, shapes in slots:
        if (len(path) >= 2 and re.fullmatch(r"branch_\d+", path[-1])
                and "multi_scale" in path[-2]):
            parent = path[:-1]
            merged.setdefault(parent, []).append((path, leaves, shapes))
        else:
            out.append((path, leaves, shapes))
    for parent, subs in merged.items():
        subs.sort(key=lambda s: int(s[0][-1].split("_")[-1]))
        leaves = [
            (coll, (sub_path[-1], key))
            for sub_path, sub_leaves, _ in subs
            for coll, key in sub_leaves
        ]
        shapes = [sh for _, _, sub_shapes in subs for sh in sub_shapes]
        out.append((parent, leaves, shapes))
    return out


_TOKEN_RE = re.compile(r"[a-z]+")


def _tokens(s: str) -> set:
    """Alphabetic name tokens only. Numeric suffixes are deliberately
    excluded from overlap scoring: Keras dedup counters count per class
    (masked_dyt, masked_dyt_1, ...) while flax layer names count every
    config entry (masked_dyt_2, masked_dyt_6, ...), so matching digits
    pairs the WRONG layers (found against a real reference-generated
    weights file). Ordering among same-shape candidates comes from the
    Keras creation ordinal instead."""
    return set(_TOKEN_RE.findall(s.lower()))


def _match(slots, groups, name_map=None):
    """Assign each slot an h5 group: shape signature first, then token
    overlap between the flax path and the h5 path."""
    name_map = dict(name_map or {})
    remaining = {i: g for i, g in enumerate(groups)}
    assignment: dict[tuple, int] = {}

    # explicit overrides first
    for path, leaves, shapes in slots:
        key = "/".join(path)
        if key in name_map:
            want = name_map[key]
            idx = next((i for i, (p, _) in remaining.items() if p == want),
                       None)
            if idx is None:
                raise KeyError(
                    f"name_map target {want!r} not found in weights file")
            assignment[path] = idx
            del remaining[idx]

    unmatched = [s for s in slots if s[0] not in assignment]
    # most-specific (longest shape signature) slots first: fewer
    # candidates.  The sort is stable, so equal-arity slots keep tree
    # traversal order == module creation order == Keras layer creation
    # order, which the ordinal tiebreak below relies on.
    unmatched.sort(key=lambda s: -len(s[2]))

    def ordinal(h5_path: str) -> tuple:
        # Creation-order key from every path component's trailing digits:
        # Keras-3 dedup counters ("dense" -> 0, "dense_1" -> 1) and
        # numbered sublayers ("bn1", "conv2"). A full-path tuple orders
        # nested layouts (stack_2/blocks/residual_block_1/bn1) correctly
        # even past 10 where alphabetical h5 iteration breaks.
        parts = [p for p in h5_path.rstrip("/").split("/") if p != "vars"]
        key = []
        for p in parts:
            m = re.search(r"(\d+)$", p)
            key.append(int(m.group(1)) if m else 0)
        return tuple(key)

    for path, leaves, shapes in unmatched:
        sig = tuple(shapes)
        cands = [i for i, (p, arrs) in remaining.items()
                 if tuple(a.shape for a in arrs) == sig]
        if not cands:
            # prefix fallback: a Keras group may carry extra variables
            # our module does not track (e.g. HyenaFilter's constant
            # pos_encoding) — trainable-first ordering puts them last,
            # so consuming the leading len(sig) arrays is safe
            cands = [
                i for i, (p, arrs) in remaining.items()
                if len(arrs) > len(sig)
                and tuple(a.shape for a in arrs[: len(sig)]) == sig
            ]
            if cands:
                logger.info(
                    "module %s: using the first %d of %d arrays from "
                    "group %s (extra untracked variables ignored)",
                    "/".join(map(str, path)), len(sig),
                    len(remaining[cands[0]][1]), remaining[cands[0]][0],
                )
        if not cands:
            inventory = [
                (p, [a.shape for a in arrs])
                for p, arrs in list(remaining.values())[:8]
            ]
            raise KeyError(
                f"no weight group in the h5 matches module "
                f"{'/'.join(path)} with shapes {sig}; remaining groups: "
                f"{inventory}"
            )
        if len(cands) > 1:
            # token overlap first (layer-name layouts carry the layer
            # kind + prefix), then the Keras creation ordinal: slots
            # arrive in creation order, so the earliest-created
            # remaining group of a tied shape is the right one.
            ftok = _tokens("/".join(path))
            cands = sorted(
                cands,
                key=lambda i: (-len(ftok & _tokens(remaining[i][0])),
                               ordinal(remaining[i][0])),
            )
        assignment[path] = cands[0]
        del remaining[cands[0]]
    if remaining:
        logger.warning(
            "%d weight group(s) in the h5 were not consumed: %s",
            len(remaining),
            [p for p, _ in remaining.values()][:8],
        )
    return assignment


def _copy_tree(tree):
    """Nested dicts copied, leaves shared (they are replaced, not
    written into)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def map_weights_to_tree(variables: dict, groups, name_map=None) -> dict:
    """Return a new variables tree with leaves replaced from *groups*."""
    slots = _tree_slots(variables)
    assignment = _match(slots, groups, name_map)

    out = _copy_tree(variables)
    n_assigned = 0
    for path, leaves, shapes in slots:
        _, arrays = groups[assignment[path]]
        for (coll, key), arr in zip(leaves, arrays):
            node = out[coll]
            for p in path:
                node = node[p]
            # merged slots (multiscale branches) carry (sub_module, key)
            sub = key if isinstance(key, tuple) else (key,)
            tgt, leaf = node, sub[-1]
            for p in sub[:-1]:
                tgt = tgt[p]
            if tuple(arr.shape) != tuple(tgt[leaf].shape):
                raise ValueError(
                    f"shape mismatch at {'/'.join(path)}/{leaf}: "
                    f"{arr.shape} vs {tgt[leaf].shape}")
            tgt[leaf] = np.asarray(arr, dtype=np.asarray(tgt[leaf]).dtype)
            n_assigned += 1
    logger.info("mapped %d tensors across %d modules", n_assigned,
                len(slots))
    return out
