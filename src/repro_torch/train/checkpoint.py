"""Template-free pytree checkpoints: the serving-artifact format.

The tree's structure is written as a JSON spec into ``manifest.json`` and
its array leaves, dtype for dtype, into ``arrays.npz`` (keys
``leaf_%06d``), so a serving artifact boots with no model code run first.
The format is the reference's (``repro/train/checkpoint.py``): the same
``step_%08d`` directory published atomically from a ``.tmp-<step>``
staging directory with ``os.replace``, the same manifest keys (``step``,
``extra``, ``spec``, ``n_arrays``) and the same node types (``none``,
``arr``, ``py``, ``dict``, ``list``, ``tuple``, ``deployed``, ``stacked``,
``serving_params``). Checkpoints the reference wrote load here, and the
reference loads the port's, except bf16 leaves, which it cannot read back
(its own included).

* int8 kernel blocks stay int8, index arrays int32, scales f32: npz is the
  at-rest format, with no float detour.
* bfloat16 has no numpy type here: a bf16 leaf is written as its raw
  2-byte records (``np.uint16`` bits viewed as ``np.dtype("V2")``: the
  data the reference's ml_dtypes leaves hold, with ``|V2`` where they have
  ``<V2`` in the npy header, and both load as ``V2``) with ``"dtype":
  "bfloat16"`` in the spec, and read back through a ``uint16`` view. It is
  never written as ``<u2``, which a reader that casts to bfloat16 would
  take for integers.
* Leaves that are the same object are stored once and loaded as one
  tensor, so the tiers of a two-tier artifact share their dense leaves on
  the device too.
* The template-driven ``save``/``restore`` of training state are not here:
  they come with training.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_SERVING_FIELDS = ("embed", "final_ln", "layers", "head", "mm_proj",
                   "head_t")
_STACKED_ARRAYS = ("blocks", "scales", "row_idx", "nnz", "col_inv")
_BF16 = "bfloat16"


def _deploy_mod():
    from ..core import deploy as D  # local: keep train importable alone
    return D


def _serving_cls():
    from ..serve.deployed import ServingParams
    return ServingParams


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as host numpy plus its spec dtype name."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits.view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def tree_spec(tree: Any, leaves: List[np.ndarray],
              _memo: Optional[dict] = None) -> Any:
    """Describe ``tree`` as JSON, appending its array leaves (host numpy,
    dtype kept) to ``leaves`` in order. A leaf met again (the same object)
    is stored once and referenced by the same index."""
    D = _deploy_mod()
    if _memo is None:
        _memo = {}
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, D.DeployedWeight):
        return {"t": "deployed", "d_in": tree.d_in, "d_out": tree.d_out,
                "bits": tree.bits,
                "packed": [tree_spec(p, leaves, _memo) for p in tree.packed]}
    if isinstance(tree, D.StackedWeight):
        return {"t": "stacked", "d_in": tree.d_in, "d_out": tree.d_out,
                "bits": tree.bits,
                "arrays": [tree_spec(getattr(tree, k, None), leaves, _memo)
                           for k in _STACKED_ARRAYS]}
    if isinstance(tree, _serving_cls()):
        return {"t": "serving_params",
                "fields": [tree_spec(getattr(tree, k, None), leaves, _memo)
                           for k in _SERVING_FIELDS]}
    if isinstance(tree, dict):
        return {"t": "dict", "items": [[str(k), tree_spec(v, leaves, _memo)]
                                       for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "items": [tree_spec(v, leaves, _memo) for v in tree]}
    if isinstance(tree, (bool, int, float, str)):
        return {"t": "py", "v": tree}
    if id(tree) in _memo:
        i, dtype = _memo[id(tree)]
    else:
        arr, dtype = _to_numpy(tree)
        leaves.append(arr)
        i = len(leaves) - 1
        _memo[id(tree)] = (i, dtype)
    return {"t": "arr", "i": i, "dtype": dtype,
            "shape": list(leaves[i].shape)}


def _leaf_tensor(arr: np.ndarray, dtype: str,
                 device: torch.device) -> torch.Tensor:
    if dtype == _BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf must hold 2-byte records, "
                             f"found {arr.dtype}")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if str(arr.dtype) != dtype:
        arr = arr.astype(dtype)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def tree_from_spec(spec: Any, leaves: List[np.ndarray],
                   device: torch.device,
                   _memo: Optional[Dict[int, torch.Tensor]] = None) -> Any:
    """Inverse of :func:`tree_spec`, with every array leaf a tensor on
    ``device``; one leaf index gives one tensor however often the spec
    refers to it."""
    D = _deploy_mod()
    if _memo is None:
        _memo = {}
    rec = lambda s: tree_from_spec(s, leaves, device, _memo)
    t = spec["t"]
    if t == "none":
        return None
    if t == "arr":
        i = spec["i"]
        if i not in _memo:
            _memo[i] = _leaf_tensor(np.asarray(leaves[i]), spec["dtype"],
                                    device)
        return _memo[i]
    if t == "py":
        return spec["v"]
    if t == "dict":
        return {k: rec(v) for k, v in spec["items"]}
    if t in ("list", "tuple"):
        out = [rec(v) for v in spec["items"]]
        return out if t == "list" else tuple(out)
    if t == "deployed":
        packed = [rec(p) for p in spec["packed"]]
        if any("col_inv" in p for p in packed):
            raise NotImplementedError(
                "this packing is macro-sharded (col_inv); macro sharding is "
                "not ported yet - save it unsharded")
        return D.DeployedWeight(packed, spec["d_in"], spec["d_out"],
                                spec["bits"])
    if t == "stacked":
        blocks, scales, row_idx, nnz, col_inv = (rec(a)
                                                 for a in spec["arrays"])
        if col_inv is not None:
            raise NotImplementedError(
                "this stack is macro-sharded (col_inv); macro sharding is "
                "not ported yet")
        return D.StackedWeight(blocks, scales, row_idx, nnz, spec["d_in"],
                               spec["d_out"], spec["bits"])
    if t == "serving_params":
        f = dict(zip(_SERVING_FIELDS, (rec(s) for s in spec["fields"])))
        if f.pop("mm_proj") is not None:
            raise NotImplementedError(
                "this artifact holds a vlm projector (mm_proj); the vlm "
                "family is not ported yet")
        return _serving_cls()(**f)
    raise ValueError(f"unknown tree-spec node type {t!r}")


def save_pytree(ckpt_dir: str, tree: Any, extra: Optional[dict] = None,
                step: int = 0) -> str:
    """Atomic template-free save: the structure into the manifest, the
    array leaves (dtype kept) into the npz. Returns the step directory."""
    leaves: List[np.ndarray] = []
    spec = tree_spec(tree, leaves)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i:06d}": a for i, a in enumerate(leaves)})
    manifest = {"step": int(step), "extra": extra or {}, "spec": spec,
                "n_arrays": len(leaves)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_pytree(ckpt_dir: str, step: Optional[int] = None,
                device: DeviceLike = None) -> Tuple[Any, dict]:
    """Load a :func:`save_pytree` directory (the latest step unless
    ``step`` is given) with no template, its leaves on ``device`` (None
    means cuda). Returns (tree, manifest)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if "spec" not in manifest:
        raise ValueError(
            f"{d} was written by the template-driven save(), which needs "
            "its template to restore; it is not a template-free pytree")
    with np.load(os.path.join(d, "arrays.npz")) as loaded:
        leaves = [loaded[f"leaf_{i:06d}"]
                  for i in range(manifest["n_arrays"])]
    return tree_from_spec(manifest["spec"], leaves, dev), manifest
