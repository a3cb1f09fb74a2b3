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

The template-driven half, for training state: :func:`save` writes each
leaf of a nested dict under its ``/``-joined key path (keys in sorted
order, as ``jax.tree_util`` flattens them; a Python int leaf, the step, as
an int32 scalar) with a manifest of ``step``, ``extra`` and
``n_arrays``, publishes it atomically and keeps the latest ``keep``
checkpoints (:func:`_gc`); :func:`restore` reads them back into the
structure, dtypes and devices of a template. A checkpoint written by
either package restores in the other.

The elastic re-mesh (the reference's ``restore(shardings=)``): a DTensor
leaf is saved as its full array (``full_tensor()``, a collective every
rank joins; with a process group up, rank 0 alone publishes and the
others wait at a barrier), so a checkpoint holds no layout; ``restore``
given a tree of ``launch.shardings.NamedSharding`` reads each sharded
leaf whole and places this rank's shard of it (JAX's even split, at the
rank's mesh coordinate) on the mesh's device as a DTensor, with no
collective, on any mesh shape.

Both halves write ``np.savez``'s file through :func:`_write_npz` and read
it through :func:`_read_npz`, each member's CRC-32 computed on a pool of
threads; a member read back is held to the size and CRC-32 that the zip
records.
"""
from __future__ import annotations

import concurrent.futures
import io
import json
import os
import shutil
import struct
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, is_dtensor, resolve_device

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
        if tree.mesh is not None:
            raise ValueError(
                "serialize placement-free packings: unshard_weight() first "
                "(mesh is excluded from artifact aux by design)")
        return {"t": "deployed", "d_in": tree.d_in, "d_out": tree.d_out,
                "bits": tree.bits,
                "packed": [tree_spec(p, leaves, _memo) for p in tree.packed]}
    if isinstance(tree, D.StackedWeight):
        if tree.mesh is not None:
            raise ValueError(
                "serialize placement-free stacks (mesh excluded from "
                "artifact aux); restack on the serving host's mesh")
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
                "this packing is macro-sharded (col_inv): artifacts hold "
                "placement-free packings (save_pytree refuses a sharded "
                "one); save it unsharded and shard it at boot")
        return D.DeployedWeight(packed, spec["d_in"], spec["d_out"],
                                spec["bits"])
    if t == "stacked":
        blocks, scales, row_idx, nnz, col_inv = (rec(a)
                                                 for a in spec["arrays"])
        if col_inv is not None:
            raise NotImplementedError(
                "this stack is macro-sharded (col_inv): artifacts hold "
                "placement-free stacks; restack on the serving host's mesh")
        return D.StackedWeight(blocks, scales, row_idx, nnz, spec["d_in"],
                               spec["d_out"], spec["bits"])
    if t == "serving_params":
        f = dict(zip(_SERVING_FIELDS, (rec(s) for s in spec["fields"])))
        return _serving_cls()(**f)
    raise ValueError(f"unknown tree-spec node type {t!r}")


def _crc32s(blobs: List[Tuple[bytes, np.ndarray]]) -> List[int]:
    """The CRC-32 of each (head, body) pair, on a pool of threads (the
    CRC releases the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(
            lambda hb: zlib.crc32(hb[1], zlib.crc32(hb[0])), blobs))


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """The file ``np.savez(path, **arrays)`` writes: a zip64 archive of
    uncompressed ``<name>.npy`` members (a 1.0 .npy header, then the
    C-order bytes). The members' CRC-32s are computed first, together
    (:func:`_crc32s`), and each member's bytes are then written in one
    call; ``np.savez`` computes them one after another while it copies each
    member out 16 MiB at a time, most of a 12.5 GB train state's save on
    the H100 machine's host (PERF.md, PR 29)."""
    blobs = []
    for name, arr in arrays.items():
        arr = np.asarray(arr, order="C")
        head = io.BytesIO()
        np.lib.format.write_array_header_1_0(
            head, np.lib.format.header_data_from_array_1_0(arr))
        blobs.append((head.getvalue(), arr.reshape(-1).view(np.uint8)))
    crcs = _crc32s(blobs)
    t = time.localtime()
    stamp = struct.pack("<HH", t.tm_hour << 11 | t.tm_min << 5
                        | t.tm_sec // 2,
                        (t.tm_year - 1980) << 9 | t.tm_mon << 5 | t.tm_mday)
    big = 0xFFFFFFFF  # the 32-bit fields that defer to the zip64 extra
    central = []
    with open(path, "wb") as f:
        for (name, _), (head, body), crc in zip(arrays.items(), blobs, crcs):
            fname = f"{name}.npy".encode()
            size = len(head) + body.nbytes
            offset = f.tell()
            f.write(struct.pack("<IHHH", 0x04034B50, 45, 0, 0) + stamp
                    + struct.pack("<IIIHH", crc, big, big, len(fname), 20)
                    + fname + struct.pack("<HHQQ", 1, 16, size, size))
            f.write(head)
            f.write(body)
            central.append(
                struct.pack("<IHHHH", 0x02014B50, 45, 45, 0, 0) + stamp
                + struct.pack("<IIIHHHHHII", crc, big, big, len(fname), 28,
                              0, 0, 0, 0o600 << 16, big)
                + fname + struct.pack("<HHQQQ", 1, 24, size, size, offset))
        cd_offset = f.tell()
        f.write(b"".join(central))
        cd_size, eocd64 = f.tell() - cd_offset, f.tell()
        n = len(central)
        f.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n,
                            n, cd_size, cd_offset)
                + struct.pack("<IIQI", 0x07064B50, 0, eocd64, 1)
                + struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF),
                              min(n, 0xFFFF), min(cd_size, big), big, 0))


def _publish(ckpt_dir: str, step: int, arrays: Dict[str, np.ndarray],
             manifest: dict) -> str:
    """Write ``arrays`` and ``manifest`` into ``.tmp-<step>`` and move it
    to ``step_<step>`` in one ``os.replace``: a crash mid-save never
    leaves a partial checkpoint under the final name."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_pytree(ckpt_dir: str, tree: Any, extra: Optional[dict] = None,
                step: int = 0) -> str:
    """Atomic template-free save: the structure into the manifest, the
    array leaves (dtype kept) into the npz. Returns the step directory."""
    leaves: List[np.ndarray] = []
    spec = tree_spec(tree, leaves)
    return _publish(
        ckpt_dir, step, {f"leaf_{i:06d}": a for i, a in enumerate(leaves)},
        {"step": int(step), "extra": extra or {}, "spec": spec,
         "n_arrays": len(leaves)})


# ---------------------------------------------------------------------------
# Template-driven: training state
# ---------------------------------------------------------------------------


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs of nested dicts in ``jax.tree_util``'s
    order: keys sorted at every level, joined with ``/``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def _leaf_array(leaf: Any) -> np.ndarray:
    if isinstance(leaf, int):  # the step: the reference's is int32
        return np.asarray(leaf, np.int32)
    if is_dtensor(leaf):  # its full array: every rank joins the gather
        leaf = leaf.full_tensor()
    return _to_numpy(leaf)[0]


def _rank() -> Optional[int]:
    """This process's rank when a process group is up, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return None


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Atomic template-driven save of ``tree`` (nested dicts of tensors,
    DTensors, arrays and Python ints) at ``step``, then keep the latest
    ``keep`` checkpoints. A DTensor leaf is written as its full array;
    with a process group up every rank calls this, rank 0 publishes and
    the others wait for it at a barrier. Returns the step directory."""
    rank = _rank()
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if rank:  # only the gathers, which every rank joins; rank 0 writes
        for _, v in flatten(tree):
            if is_dtensor(v):
                v.full_tensor()
    try:
        if not rank:
            arrays = {k: _leaf_array(v) for k, v in flatten(tree)}
            _publish(ckpt_dir, step, arrays,
                     {"step": int(step), "extra": extra or {},
                      "n_arrays": len(arrays)})
            _gc(ckpt_dir, keep)
    finally:
        if rank is not None:  # reached by rank 0 even when it raises
            import torch.distributed as dist
            dist.barrier()
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    """Delete all but the latest ``keep`` ``step_*`` directories."""
    ckpts = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _as_tensor(arr: np.ndarray, like: torch.Tensor,
               device: torch.device) -> torch.Tensor:
    """``arr`` as a tensor of the template leaf's dtype on ``device``."""
    if like.dtype == torch.bfloat16 and arr.dtype.kind == "V":
        return _leaf_tensor(arr, _BF16, device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, like.dtype)


def _restore_leaf(arr: np.ndarray, like: Any, sharding: Any = None) -> Any:
    """``arr`` in the type, dtype and device of the template leaf, or,
    with a ``sharding``, this rank's shard of it as a DTensor."""
    if sharding is not None:
        return _sharded_leaf(arr, like, sharding)
    if torch.is_tensor(like):
        t = _as_tensor(arr, like, like.device)
        return t.requires_grad_() if like.requires_grad else t
    if isinstance(like, int):
        return int(arr)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def _mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``: the CPU, or the
    current card (which ``DeviceMesh`` sets from the local rank); a CUDA
    mesh never falls back to the CPU."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"no shard placement on a {mesh.device_type} mesh")


def _shard_index(shape, sharding) -> Tuple[slice, ...]:
    """This rank's block of an array of ``shape`` under ``sharding`` (a
    ``launch.shardings.NamedSharding``), as JAX splits it: each dim in
    equal blocks over the axes its spec entry names, the first the major
    one, the block at the rank's mesh coordinate. A dim its axes do not
    divide raises ValueError, as ``jax.device_put`` does."""
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the array's "
                         f"{len(shape)} dims")
    names = tuple(mesh.mesh_dim_names)
    sizes, coord = tuple(mesh.shape), mesh.get_coordinate()
    index = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        parts, block = 1, 0
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                i = names.index(a)
                parts, block = parts * sizes[i], block * sizes[i] + coord[i]
        if n % parts:
            raise ValueError(
                f"spec {spec} splits dim {d} of shape {tuple(shape)} into "
                f"{parts} parts, which do not divide {n}")
        index.append(slice(block * (n // parts), (block + 1) * (n // parts)))
    return tuple(index)


def _sharded_leaf(arr: np.ndarray, like: Any, sharding) -> Any:
    """This rank's shard of the whole leaf ``arr`` (cast to the template
    leaf's dtype) on the mesh's device, as a DTensor of the sharding's
    placements: a local cut, no collective."""
    from torch.distributed.tensor import DTensor
    if not torch.is_tensor(like):
        if isinstance(like, int):
            raise ValueError("a Python int leaf (the step) takes no "
                             "sharding")
        like = torch.from_numpy(np.empty(0, np.asarray(like).dtype))
    placements = sharding.placements()
    full = _as_tensor(arr, like, torch.device("cpu"))
    piece = full[_shard_index(full.shape, sharding)]
    # a copy of its own, contiguous: a view would keep the whole leaf alive
    local = torch.empty(piece.shape, dtype=piece.dtype,
                        device=_mesh_device(sharding.mesh)).copy_(piece)
    out = DTensor.from_local(local, sharding.mesh, placements,
                             run_check=False, shape=full.shape,
                             stride=full.stride())
    return out.requires_grad_() if like.requires_grad else out


def _unflatten(template: Any, values: Dict[str, Any], prefix: str = ""
               ) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix
                              else str(k)) for k, v in template.items()}
    return values[prefix]


_NPY_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _read_member(zf: zipfile.ZipFile, path: str, info: zipfile.ZipInfo
                 ) -> np.ndarray:
    """One array of the npz at ``path``. A member stored uncompressed with
    a 1.0 or 2.0 .npy header, as ``np.savez`` writes them, is read with
    one ``np.fromfile`` at its offset and held to the zip's size and
    CRC-32 as ``zipfile`` holds a member it reads (``BadZipFile``
    otherwise). Any other member goes through ``np.load``'s reader."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        if (info.compress_type == zipfile.ZIP_STORED
                and local[:4] == b"PK\x03\x04"):
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            start = info.header_offset + 30 + name_len + extra_len
            f.seek(start)
            read_header = _NPY_HEADERS.get(np.lib.format.read_magic(f))
            if read_header is not None:
                shape, fortran, dtype = read_header(f)
                n_head = f.tell() - start
                count = int(np.prod(shape, dtype=np.int64))
                arr = np.fromfile(f, dtype=dtype, count=count)
                if (arr.size != count or n_head + arr.nbytes
                        != info.file_size):
                    raise zipfile.BadZipFile(
                        f"member {info.filename!r} is truncated")
                f.seek(start)
                crc = zlib.crc32(arr.view(np.uint8), zlib.crc32(
                    f.read(n_head)))
                if crc != info.CRC:
                    raise zipfile.BadZipFile(
                        f"Bad CRC-32 for file {info.filename!r}")
                return arr.reshape(shape, order="F" if fortran else "C")
    with zf.open(info) as member:
        return np.lib.format.read_array(member, allow_pickle=False)


def _read_npz(path: str, names: List[str]) -> List[np.ndarray]:
    """The arrays ``names`` of the npz at ``path``, in order, each read by
    :func:`_read_member` on a pool of threads (``np.fromfile`` and the
    CRC release the GIL). ``np.load`` copies a member through the zip
    reader 256 KB at a time: a 12.5 GB train state's restore took 26 s
    longer with it on the H100 machine's host (PERF.md, PR 29)."""
    with zipfile.ZipFile(path) as zf:
        infos = {i.filename: i for i in zf.infolist()}
        with concurrent.futures.ThreadPoolExecutor(
                min(8, os.cpu_count() or 1)) as pool:
            return list(pool.map(
                lambda n: _read_member(zf, path, infos[n + ".npy"]), names))


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, dict]:
    """Restore the latest checkpoint (or ``step``) into the structure of
    ``template``: each leaf in the template leaf's dtype and on its device
    (a tensor that requires a gradient comes back requiring one). With
    ``shardings``, a tree of ``launch.shardings.NamedSharding`` (or None)
    matching ``template``, a leaf with a sharding comes back as this
    rank's shard, a DTensor on the sharding's mesh (the elastic re-mesh,
    module docstring). Returns (tree, manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = flatten(template)
    arrays = _read_npz(os.path.join(d, "arrays.npz"), [k for k, _ in pairs])
    shard_of = dict(flatten(shardings)) if shardings is not None else {}
    values = {k: _restore_leaf(arr, leaf, shard_of.get(k))
              for (k, leaf), arr in zip(pairs, arrays)}
    return _unflatten(template, values), manifest


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
    leaves = _read_npz(os.path.join(d, "arrays.npz"),
                       [f"leaf_{i:06d}" for i in range(manifest["n_arrays"])])
    return tree_from_spec(manifest["spec"], leaves, dev), manifest
