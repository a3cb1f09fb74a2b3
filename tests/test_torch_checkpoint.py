"""The port's template-free pytree checkpoints against the reference's
(``repro.train.checkpoint``): one on-disk format, read and written by
both sides.

Every comparison is exact: leaves carry their dtype through npz (int8
stays int8, bf16 crosses as its 16 raw bits), and the JSON spec carries
the structure and the deployment geometry. The reference cannot read back
a bf16 leaf, its own or the port's (``tree_from_spec`` casts the raw
``V2`` records with ``astype("bfloat16")``, which numpy refuses), so the
port-to-reference direction is held on f32, int8 and int32 trees.

The elastic re-mesh (``restore(shardings=)``) runs the reference's case
in both packages, each in ONE subprocess: the reference on 8 fake host
devices, the port on 8 spawned gloo ranks, every shard held against the
reference's shard at the same mesh coordinate.
"""
import json
import os
import signal
import subprocess
import sys

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


# ---------------------------------------------------------------------------
# The elastic re-mesh: restore(shardings=) on 8 ranks, against the
# reference's case (tests/test_distributed.py::test_elastic_checkpoint_remesh)
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference, 8 fake host devices: its own checkpoint of x saved from a
# (2, 4) mesh, restored onto (4, 2) by the reference's restore(shardings=);
# each device of the (4, 2) mesh writes its coordinate, its shard's index
# (the start of each dim) and values, also for a tuple entry in and out of
# mesh order; the verdict on a dim its axes do not divide
REF_REMESH = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.train import checkpoint
out = sys.argv[1]
mesh_a = jax.make_mesh((2, 4), ("data", "model"))
x = jnp.arange(64.0).reshape(8, 8)
y = jnp.arange(32.0).reshape(16, 2)
checkpoint.save(out + "/ref_ck", 1, {
    "x": jax.device_put(x, NamedSharding(mesh_a, P("data", "model"))),
    "y": y})
mesh_b = jax.make_mesh((4, 2), ("data", "model"))
specs = {"x": P("model", "data"), "y": P(("data", "model"), None),
         "y_rev": P(("model", "data"), None)}
restored, _ = checkpoint.restore(
    out + "/ref_ck", {"x": x, "y": y},
    shardings={k: NamedSharding(mesh_b, specs[k]) for k in ("x", "y")})
arrays = dict(restored, y_rev=jax.device_put(
    y, NamedSharding(mesh_b, specs["y_rev"])))
rec = {}
for name, arr in arrays.items():
    assert arr.sharding.spec == specs[name]
    for s in arr.addressable_shards:
        i, j = (int(c) for c in np.argwhere(mesh_b.devices == s.device)[0])
        rec[f"{name} {i} {j}"] = [[sl.start or 0 for sl in s.index],
                                  np.asarray(s.data).tolist()]
try:
    jax.device_put(jnp.zeros((6, 8)), NamedSharding(mesh_b, P("data", None)))
    rec["indivisible"] = "placed"
except ValueError as e:
    rec["indivisible"] = "ValueError"
with open(out + "/ref.json", "w") as f:
    json.dump(rec, f)
'''

# the port, 8 gloo ranks on the CPU (spawned): the same x saved from a
# (2, 4) DeviceMesh with a bf16 leaf, unsharded leaves and the step, then
# restored onto (4, 2), and the reference's checkpoint restored as well;
# each rank writes what it holds
PORT_REMESH = r'''
import json, os, socket, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def worker(rank, out, port):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.launch.shardings import NamedSharding, to_placements
    from repro_torch.train import checkpoint as CK
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=8)
    mesh_a = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    x = torch.arange(64.0).reshape(8, 8)
    b = (torch.arange(64.0).reshape(8, 8) / 7).to(torch.bfloat16)
    u = torch.arange(5, dtype=torch.int32)
    spec_a = ("data", "model")
    copies, to_numpy = [], CK._to_numpy
    CK._to_numpy = lambda leaf: (copies.append(1), to_numpy(leaf))[1]
    CK.save(out + "/port_ck", 1, {
        "x": distribute_tensor(x, mesh_a, to_placements(spec_a, mesh_a)),
        "b": distribute_tensor(b, mesh_a, to_placements(spec_a, mesh_a)),
        "u": u, "odd": torch.zeros(6, 8), "step": 5})
    CK._to_numpy = to_numpy
    mesh_b = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    nb = lambda spec: NamedSharding(mesh_b, spec)
    tree, man = CK.restore(
        out + "/port_ck", {"x": x, "b": torch.zeros(8, 8, dtype=torch.bfloat16),
                           "u": u, "step": 0},
        shardings={"x": nb(("model", "data")), "b": nb(("model", "data")),
                   "u": None, "step": None})
    ref, _ = CK.restore(out + "/ref_ck", {"x": x, "y": torch.zeros(16, 2)},
                        shardings={"x": nb(("model", "data")),
                                   "y": nb((("data", "model"), None))})
    def held(t):
        _, offset = compute_local_shape_and_global_offset(
            t.shape, t.device_mesh, t.placements)
        return [list(offset), t.to_local().float().tolist(),
                [str(p) for p in t.placements], str(t.to_local().dtype)]
    rec = {"rank": rank, "host_copies": len(copies),
           "coord": list(mesh_b.get_coordinate()), "x": held(tree["x"]),
           "b": held(tree["b"]), "ref_x": held(ref["x"]),
           "ref_y": held(ref["y"]), "u": [type(tree["u"]).__name__,
                                          tree["u"].tolist()],
           "step": [type(tree["step"]).__name__, tree["step"]],
           "manifest_step": man["step"],
           "want_placements": [str(p) for p in to_placements(
               ("model", "data"), mesh_b)]}
    for name, ck, key, spec in (
            ("y_rev", "ref_ck", "y", (("model", "data"), None)),
            ("indivisible", "port_ck", "odd", ("data", None))):
        try:
            CK.restore(f"{out}/{ck}", {key: torch.zeros(1)},
                       shardings={key: nb(spec)})
            rec[name] = "placed"
        except ValueError:
            rec[name] = "ValueError"
    # a save whose publishing fails on rank 0: every rank still passes the
    # barrier, rank 0 raises
    if rank == 0:
        def publish(*args):
            raise OSError("no space left")
        CK._publish = publish
    try:
        CK.save(out + "/port_ck", 2, {"x": distribute_tensor(
            x, mesh_a, to_placements(spec_a, mesh_a))})
        rec["failed_save"] = "returned"
    except OSError:
        rec["failed_save"] = "raised"
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()

if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(worker, args=(sys.argv[1], port), nprocs=8,
                       start_method="spawn")
'''


def _run(program, out, env):
    """``program`` as a script of its own (spawned workers import it)."""
    path = os.path.join(out, "program.py")
    with open(path, "w") as f:
        f.write(program)
    proc = subprocess.Popen([sys.executable, path, out], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:  # the spawned ranks go with it
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def remesh(tmp_path_factory):
    """The reference's run, then the port's 8 ranks (which restore the
    reference's checkpoint): ({coordinate: rank record}, reference
    record, the directory)."""
    out = str(tmp_path_factory.mktemp("remesh"))
    base = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    _run(REF_REMESH, out, dict(
        base, XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    _run(PORT_REMESH, out, base)
    ranks = []
    for r in range(8):
        with open(f"{out}/rank{r}.json") as f:
            ranks.append(json.load(f))
    with open(f"{out}/ref.json") as f:
        ref = json.load(f)
    return {tuple(rec["coord"]): rec for rec in ranks}, ref, out


def test_remesh_shards_equal_the_reference(remesh):
    """The reference's case: x saved from (2, 4) with P("data", "model"),
    restored onto (4, 2) with P("model", "data"). Every coordinate's shard
    has the reference's offsets and values, and the placements are
    to_placements' (Shard(1), Shard(0))."""
    port, ref, _ = remesh
    assert sorted(port) == [(i, j) for i in range(4) for j in range(2)]
    for (i, j), rec in port.items():
        offset, values, placements, dtype = rec["x"]
        assert [offset, values] == ref[f"x {i} {j}"], (i, j)
        assert placements == rec["want_placements"] == ["S(1)", "S(0)"]
        assert dtype == "torch.float32"
        # the reference's own checkpoint restores to the same shards
        assert rec["ref_x"][:2] == ref[f"x {i} {j}"], (i, j)


def test_remesh_tree_keeps_unsharded_leaves_bf16_and_the_step(remesh):
    """A tree mixing sharded and unsharded leaves: the unsharded int32
    leaf comes back a plain tensor, unchanged; the step an int; the bf16
    leaf sharded in bf16, its values the slice of the saved array."""
    port, _, _ = remesh
    b = (torch.arange(64.0).reshape(8, 8) / 7).to(torch.bfloat16).float()
    for (i, j), rec in port.items():
        assert rec["u"] == ["Tensor", [0, 1, 2, 3, 4]]
        assert rec["step"] == ["int", 5] and rec["manifest_step"] == 1
        offset, values, placements, dtype = rec["b"]
        assert dtype == "torch.bfloat16"
        assert offset == [4 * j, 2 * i]
        assert values == b[4 * j:4 * j + 4, 2 * i:2 * i + 2].tolist()


def test_remesh_tuple_entry_and_indivisible_dim(remesh):
    """A tuple entry in mesh order splits as JAX splits it (the first axis
    the major one); in any other order JAX splits otherwise than DTensor
    would, and the port refuses it. A dim its axes do not divide: the
    reference refuses, and so does the port."""
    port, ref, _ = remesh
    for (i, j), rec in port.items():
        assert rec["ref_y"][:2] == ref[f"y {i} {j}"], (i, j)
        assert rec["ref_y"][2] == ["S(0)", "S(0)"]
        assert rec["y_rev"] == "ValueError"
        assert rec["indivisible"] == "ValueError"
    # the two orders do split otherwise in JAX
    assert any(ref[f"y {i} {j}"] != ref[f"y_rev {i} {j}"] for i, j in port)
    assert ref["indivisible"] == "ValueError"


def test_remesh_save_publishes_from_rank_0_only(remesh):
    """With a process group up, only rank 0 copies the leaves to the host
    (four arrays; the step is an int) and publishes; the other ranks join
    the gathers alone. When rank 0's publishing raises, it still reaches
    the barrier: the other ranks return, rank 0 raises, and no step is
    published."""
    port, _, out = remesh
    for rec in port.values():
        first = rec["rank"] == 0
        assert rec["host_copies"] == (4 if first else 0), rec["rank"]
        assert rec["failed_save"] == ("raised" if first else "returned")
    assert port[0, 0]["rank"] == 0
    assert not os.path.exists(out + "/port_ck/step_00000002")


def test_remesh_checkpoint_restores_in_the_reference(remesh):
    """The 8 ranks' checkpoint (rank 0 published it) holds full arrays in
    the reference's format: the reference restores it (all but the bf16
    leaf, which it cannot read, module docstring)."""
    _, _, out = remesh
    back, man = RCK.restore(out + "/port_ck", {
        "step": 0, "u": jnp.zeros(5, jnp.int32), "x": jnp.zeros((8, 8))})
    assert man["step"] == 1 and int(back["step"]) == 5
    np.testing.assert_array_equal(np.asarray(back["x"]),
                                  np.arange(64.0).reshape(8, 8))
    np.testing.assert_array_equal(np.asarray(back["u"]), np.arange(5))
    assert sorted(os.listdir(out + "/port_ck")) == ["step_00000001"]
