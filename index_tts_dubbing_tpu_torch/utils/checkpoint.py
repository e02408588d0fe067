"""Param-tree checkpoint IO.

Replaces the reference's torch.load flow (utils/checkpoint.py:25-34) with a
torch-free on-disk format: a single .npz of '/'-joined flattened tree keys.
List subtrees use integer path components. Conversion from the reference's
.pth files lives in utils/convert.py (torch needed only there).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Union

import numpy as np

Tree = Union[Dict[str, Any], List[Any], np.ndarray]


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Tree:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(path: str | Path, params: Tree) -> None:
    flat = flatten_tree(params)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_params(path: str | Path) -> Tree:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_tree(flat)
