"""The port's training specs (``launch/shardings.py``: ``data_axes``,
``param_specs``, ``cache_specs``, ``batch_specs``, ``zero1_specs``,
``to_placements``) against the reference's, as tuples, for every
architecture, ``opt`` off and on (the dry run's ``OPT_OVERRIDES`` applied
to the config, as its ``--opt`` does), batch 1 and more, on the (16, 16)
and the (2, 16, 16) production meshes. The reference's functions read only
``mesh.shape`` and ``mesh.axis_names``, so a stand-in object is its mesh;
``zero1_specs`` reads the parameters' shapes, ``jax.eval_shape`` of its
init on one side and the port's init on the meta device on the other.
"""
import dataclasses

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.launch import shardings as RSH  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.models.config import SHAPES as RSHAPES  # noqa: E402
from repro_torch.launch import shardings as TSH  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.config import SHAPES as TSHAPES  # noqa: E402

# the reference dry run's --opt overrides (launch/dryrun.py)
OPT = dict(attn_chunk=1024, head_pad=16, moe_group_size=128,
           capacity_factor=1.0, ssm_chunk=128, ssd_lowp=True,
           ssm_split_proj=True, vocab_pad_multiple=256)


class Mesh:
    def __init__(self, multi_pod):
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


MESHES = {"16x16": Mesh(False), "2x16x16": Mesh(True)}


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _configs(arch, opt):
    over = OPT if opt else {}
    return RR.get_config(arch, **over), TR.get_config(arch, **over)


def test_arch_ids_shapes_and_cells_match_reference():
    assert TR.ARCH_IDS == RR.ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in TSHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in RSHAPES.items()}
    for arch in RR.ARCH_IDS:
        assert TR.supported_cells(arch) == RR.supported_cells(arch)


@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_param_and_zero1_specs_match_reference(arch):
    for opt in (False, True):
        rcfg, tcfg = _configs(arch, opt)
        rspec = RSH.param_specs(rcfg, 16, opt=opt)
        tspec = TSH.param_specs(tcfg, 16, opt=opt)
        assert tspec == _as_tuples(rspec)
        rshape = jax.eval_shape(lambda: RR.model_fns(rcfg).init_params(
            rcfg, jax.random.PRNGKey(0)))
        tshape = TR.model_fns(tcfg).init_params(tcfg, None, "meta")
        # the port's tree is the reference's, shape for shape
        assert jax.tree_util.tree_structure(rshape) == \
            jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda t: 0, tshape))
        assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(tshape)] \
            == [t.shape for t in jax.tree_util.tree_leaves(rshape)]
        for name, mesh in MESHES.items():
            want = RSH.zero1_specs(rspec, rshape, mesh)
            assert TSH.zero1_specs(tspec, tshape, mesh) == _as_tuples(want), \
                (opt, name)


@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_cache_batch_and_data_specs_match_reference(arch):
    for opt in (False, True):
        rcfg, tcfg = _configs(arch, opt)
        for name, mesh in MESHES.items():
            assert TSH.data_axes(mesh) == RSH.data_axes(mesh)
            for batch in (1, 2, 128):
                assert TSH.cache_specs(tcfg, mesh, batch, opt=opt) == \
                    _as_tuples(RSH.cache_specs(rcfg, mesh, batch, opt=opt))
            for shape in list(RSHAPES.values()) + [
                    dataclasses.replace(RSHAPES["train_4k"],
                                        global_batch=1)]:
                tshape = TSHAPES.get(shape.name)
                if shape.global_batch == 1 and shape.kind == "train":
                    tshape = dataclasses.replace(tshape, global_batch=1)
                assert TSH.batch_specs(tcfg, mesh, tshape) == _as_tuples(
                    RSH.batch_specs(rcfg, mesh, shape))


def test_to_placements_and_mesh_axes():
    """A spec's placements over a DeviceMesh: Shard on each mesh dim whose
    axis names a tensor dim (a tuple entry over all its axes), Replicate
    elsewhere. The mesh is only read, so a stand-in serves."""
    from torch.distributed.tensor import Replicate, Shard

    class DM:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert TSH.mesh_axes(DM) == {"pod": 2, "data": 16, "model": 16}
    assert TSH.data_axes(DM) == ("pod", "data")
    assert TSH.to_placements((("pod", "data"), None, "model"), DM) == (
        Shard(0), Shard(0), Shard(2))
    assert TSH.to_placements((None, "model"), DM) == (
        Replicate(), Replicate(), Shard(1))
    assert TSH.to_placements((), DM) == (Replicate(),) * 3
    t = torch.zeros(4, 4)
    assert TSH.constrain(t, ("data", None)) is t  # plain: untouched
