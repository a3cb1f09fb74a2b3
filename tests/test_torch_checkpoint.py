"""The port's template-free pytree checkpoints against the reference's
(``repro.train.checkpoint``): one on-disk format, read and written by
both sides.

Every comparison is exact: leaves carry their dtype through npz (int8
stays int8, bf16 crosses as its 16 raw bits), and the JSON spec carries
the structure and the deployment geometry. The reference cannot read back
a bf16 leaf, its own or the port's (``tree_from_spec`` casts the raw
``V2`` records with ``astype("bfloat16")``, which numpy refuses), so the
port-to-reference direction is held on f32, int8 and int32 trees.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as RD
from repro.kernels import ops as ROPS
from repro.serve import deployed as RDP
from repro.train import checkpoint as RCK
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import deploy as TD
from repro_torch.serve import deployed as TDP
from repro_torch.train import checkpoint as TCK

CPU = torch.device("cpu")


def _packed(rng, k, n, bk, bn, density):
    keep = rng.random((k // bk, n // bn)) < density
    levels = rng.integers(-7, 8, (k, n)) * np.repeat(
        np.repeat(keep, bk, 0), bn, 1)
    return ROPS.pack_for_kernel(levels / 8.0, bits=4, bk=bk, bn=bn)


def _reference_tree(with_bf16: bool):
    """A reference tree with every node type the format has. ``shared``
    appears three times by reference."""
    rng = np.random.default_rng(0)
    shared = jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)
    dw = RD.DeployedWeight([_packed(rng, 32, 48, 16, 16, 0.5)], 32, 48, 4)
    dw2 = RD.DeployedWeight([_packed(rng, 32, 48, 16, 16, 0.7)], 32, 48, 4)
    layers = [{"ln1": jnp.asarray(rng.standard_normal(8), jnp.float32),
               "wq": w} for w in (dw, dw2)]
    tree = {
        "f32": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
        "i8": jnp.asarray(rng.integers(-128, 128, (7,)), jnp.int8),
        "i32": jnp.asarray(rng.integers(-2 ** 31, 2 ** 31 - 1, (2, 3)),
                           jnp.int32),
        "py": [1, 2.5, True, "tile", None],
        "tuple": (shared, shared, 3),
        "nested": {"again": shared, "empty": {}},
        "deployed": dw,
        "stacked": RD.stack_deployed([dw, dw2]),
        "serving": RDP.ServingParams(
            embed=jnp.asarray(rng.standard_normal((16, 8)), jnp.float32),
            final_ln=jnp.asarray(rng.standard_normal(8), jnp.float32),
            layers=layers, head=dw),
    }
    if with_bf16:
        tree["bf16"] = jnp.asarray(rng.standard_normal((5, 9)) * 3,
                                   jnp.bfloat16)
    return tree


def _to_port(tree, memo=None):
    """The same tree with the port's classes and tensors; a leaf shared in
    the reference tree is one tensor here too."""
    memo = {} if memo is None else memo
    rec = lambda v: _to_port(v, memo)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, RD.DeployedWeight):
        return TD.DeployedWeight(rec(tree.packed), tree.d_in, tree.d_out,
                                 tree.bits)
    if isinstance(tree, RD.StackedWeight):
        return TD.StackedWeight(rec(tree.blocks), rec(tree.scales),
                                rec(tree.row_idx), rec(tree.nnz), tree.d_in,
                                tree.d_out, tree.bits)
    if isinstance(tree, RDP.ServingParams):
        return TDP.ServingParams(rec(tree.embed), rec(tree.final_ln),
                                 rec(tree.layers), rec(tree.head),
                                 rec(tree.head_t))
    if isinstance(tree, dict):
        return {k: rec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rec(v) for v in tree)
    if id(tree) not in memo:
        memo[id(tree)] = tensor_from_numpy(np.asarray(tree), CPU)
    return memo[id(tree)]


def _bits(a):
    """Exact bit pattern and dtype name of a leaf from either side."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return a.numpy(), str(a.numpy().dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _assert_same(port, ref, path="tree"):
    """Structure, geometry, dtypes and every bit equal."""
    if isinstance(ref, RD.DeployedWeight):
        assert isinstance(port, TD.DeployedWeight), path
        assert (port.d_in, port.d_out, port.bits) == (ref.d_in, ref.d_out,
                                                      ref.bits), path
        return _assert_same(port.packed, ref.packed, path + ".packed")
    if isinstance(ref, RD.StackedWeight):
        assert isinstance(port, TD.StackedWeight), path
        assert ref.col_inv is None
        assert (port.d_in, port.d_out, port.bits) == (ref.d_in, ref.d_out,
                                                      ref.bits), path
        for k in ("blocks", "scales", "row_idx", "nnz"):
            _assert_same(getattr(port, k), getattr(ref, k), f"{path}.{k}")
        return
    if isinstance(ref, RDP.ServingParams):
        assert isinstance(port, TDP.ServingParams), path
        assert ref.mm_proj is None
        for k in ("embed", "final_ln", "layers", "head", "head_t"):
            _assert_same(getattr(port, k), getattr(ref, k), f"{path}.{k}")
        return
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), path
        for k in ref:
            _assert_same(port[k], ref[k], f"{path}.{k}")
        return
    if isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_same(p, r, f"{path}[{i}]")
        return
    if ref is None or isinstance(ref, (bool, int, float, str)):
        assert port == ref and type(port) is type(ref), path
        return
    (pb, pd), (rb, rd) = _bits(port), _bits(ref)
    assert pd == rd, (path, pd, rd)
    assert pb.shape == rb.shape and np.array_equal(pb, rb), path


def _manifest(d):
    with open(os.path.join(d, "step_00000000", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("with_bf16", [False, True])
def test_reference_save_port_load_is_exact(tmp_path, with_bf16):
    ref = _reference_tree(with_bf16)
    RCK.save_pytree(str(tmp_path), ref, extra={"note": "ref"})
    tree, manifest = TCK.load_pytree(str(tmp_path), device="cpu")
    assert manifest["extra"] == {"note": "ref"}
    _assert_same(tree, ref)
    # the shared leaf is one tensor after loading
    assert tree["tuple"][0] is tree["tuple"][1] is tree["nested"]["again"]


def test_port_save_reference_load_is_exact(tmp_path):
    ref = _reference_tree(with_bf16=False)
    TCK.save_pytree(str(tmp_path), _to_port(ref), extra={"note": "port"},
                    step=3)
    assert TCK.latest_step(str(tmp_path)) == RCK.latest_step(
        str(tmp_path)) == 3
    back, manifest = RCK.load_pytree(str(tmp_path))
    assert manifest["extra"] == {"note": "port"}
    _assert_same(_to_port(back), ref)


def test_port_roundtrip_bf16_is_exact(tmp_path):
    ref = _reference_tree(with_bf16=True)
    port = _to_port(ref)
    TCK.save_pytree(str(tmp_path), port)
    back, _ = TCK.load_pytree(str(tmp_path), device="cpu")
    _assert_same(back, ref)
    # written as raw 2-byte records (the reference's layout), never <u2
    spec_bf16 = dict(_manifest(str(tmp_path))["spec"]["items"])["bf16"]
    assert spec_bf16["dtype"] == "bfloat16"
    with np.load(os.path.join(tmp_path, "step_00000000",
                              "arrays.npz")) as z:
        stored = z[f"leaf_{spec_bf16['i']:06d}"]
    assert stored.dtype.kind == "V" and stored.dtype.itemsize == 2


@pytest.mark.parametrize("with_bf16", [False, True])
def test_manifest_spec_matches_reference(tmp_path, with_bf16):
    ref = _reference_tree(with_bf16)
    RCK.save_pytree(str(tmp_path / "ref"), ref)
    TCK.save_pytree(str(tmp_path / "port"), _to_port(ref))
    want, got = _manifest(str(tmp_path / "ref")), _manifest(
        str(tmp_path / "port"))
    assert got == want


def test_shared_leaf_is_stored_once(tmp_path):
    t = torch.arange(6, dtype=torch.float32)
    tree = {"a": t, "b": [t, (t,)], "c": torch.zeros(2)}
    TCK.save_pytree(str(tmp_path), tree)
    assert _manifest(str(tmp_path))["n_arrays"] == 2
    back, _ = TCK.load_pytree(str(tmp_path), device="cpu")
    assert back["a"] is back["b"][0] is back["b"][1][0]
    assert torch.equal(back["a"], t)


def test_load_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        TCK.load_pytree(str(tmp_path / "missing"), device="cpu")
    RCK.save(str(tmp_path / "templ"), 0, {"w": jnp.ones(2)})
    with pytest.raises(ValueError, match="template"):
        TCK.load_pytree(str(tmp_path / "templ"), device="cpu")
