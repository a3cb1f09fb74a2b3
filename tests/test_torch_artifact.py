"""The port's serving artifacts (``serve.deployed`` save/load/validate)
against the reference's.

The reference packs the smoke yi-6b (``compress(tile=(16, 16))``, as its
CLI does with ``--tile``) and writes the artifact; the port boots it with
no re-packing. The int8 blocks, ``row_idx``, ``nnz``, scales and every
dense leaf must be bit-identical, in f32 and in bf16 (bf16 leaves cross as
their raw 16 bits).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import deploy as RD
from repro.models import registry as RR
from repro.serve import deployed as RDP
from repro.serve import spec as RSPEC
from repro_torch.models import registry as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import deployed as TDP

KEYS = ("blocks", "scales", "row_idx", "nnz")


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _np_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_leaf(got, want, what):
    g, w = _bits(got), _np_bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    assert np.array_equal(g, w), what


def _assert_same_serving(tsp, rsp):
    """Packings, dense leaves and geometry bit for bit."""
    _assert_leaf(tsp.embed, rsp.embed, "embed")
    _assert_leaf(tsp.final_ln, rsp.final_ln, "final_ln")
    assert len(tsp.layers) == len(rsp.layers)
    pairs = [(f"blk{i}.{k}", tp[k], rp[k])
             for i, (tp, rp) in enumerate(zip(tsp.layers, rsp.layers))
             for k in rp]
    pairs.append(("head", tsp.head, rsp.head))
    for name, t, r in pairs:
        if isinstance(r, RD.DeployedWeight):
            assert (t.d_in, t.d_out, t.bits, t.tile) == (r.d_in, r.d_out,
                                                         r.bits, r.tile)
            for tp, rp in zip(t.packed, r.packed):
                for k in KEYS:
                    _assert_leaf(tp[k], rp[k], f"{name}.{k}")
                assert tp["density"] == rp["density"]
        else:
            _assert_leaf(t, r, name)


@pytest.fixture(scope="module")
def reference_artifacts(tmp_path_factory):
    """The reference's packed smoke yi-6b, saved in f32 and in bf16."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = RR.get_smoke_config("yi-6b", dtype=dtype)
        params = RR.model_fns(cfg).init_params(cfg, jax.random.PRNGKey(0))
        rsp = RDP.compress(cfg, params, target_sparsity=0.6, tile=(16, 16))
        path = str(tmp_path_factory.mktemp(f"art_{dtype}"))
        RDP.save_artifact(path, rsp, cfg, extra={"compressed": True})
        out[dtype] = (cfg, rsp, path)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_boots_reference_artifact_exactly(reference_artifacts, dtype):
    cfg, rsp, path = reference_artifacts[dtype]
    tsp, extra = TDP.load_artifact(path, arch=cfg.name, tile=(16, 16),
                                   device="cpu")
    assert extra["arch"] == cfg.name and extra["compressed"] is True
    assert TDP.packed_tiles(tsp) == RDP.packed_tiles(rsp) == [(16, 16)]
    _assert_same_serving(tsp, rsp)


def test_reference_boots_port_artifact_exactly(reference_artifacts,
                                               tmp_path):
    cfg, rsp, path = reference_artifacts["float32"]
    tsp, _ = TDP.load_artifact(path, device="cpu")
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32")
    TDP.save_artifact(str(tmp_path), tsp, tcfg, extra={"compressed": True})
    back, extra = RDP.load_artifact(str(tmp_path), arch=cfg.name,
                                    tile=(16, 16))
    assert extra == RDP.load_artifact_extra(path)
    _assert_same_serving(tsp, back)


@pytest.mark.parametrize("field,expect", [
    ("schema", {}),
    ("arch", {"arch": "llama-7b"}),
    ("family", {"family": "moe"}),
    ("tile", {"tile": (32, 32)}),
    ("tiles", {"tile": (16, 16)}),  # a non-uniform packing
])
def test_validate_artifact_refuses_as_reference(field, expect):
    extra = {"schema": 1, "arch": "yi-6b-smoke", "family": "dense",
             "tiles": [[16, 16]]}
    if field == "schema":
        extra["schema"] = TDP.ARTIFACT_SCHEMA + 1
    if field == "tiles":
        extra["tiles"] = [[16, 16], [8, 16]]
    with pytest.raises(ValueError) as want:
        RDP.validate_artifact("/art", extra, **expect)
    with pytest.raises(ValueError) as got:
        TDP.validate_artifact("/art", extra, **expect)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("/art: ")
    # the matching expectations, and absent fields, pass
    ok = {"arch": "yi-6b-smoke", "family": "dense", "tile": (16, 16)}
    TDP.validate_artifact("/art", {"schema": 1, **{
        k: v for k, v in extra.items() if k not in ("schema", field)}}, **ok)
    TDP.validate_artifact("/art", {}, **ok)


def test_boot_checks_the_manifest_first(reference_artifacts):
    _, _, path = reference_artifacts["float32"]
    with pytest.raises(ValueError, match="arch mismatch"):
        TDP.load_artifact(path, arch="yi-6b", device="cpu")
    with pytest.raises(ValueError, match="tile mismatch"):
        TDP.load_artifact(path, tile=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="no draft packing"):
        TDP.load_artifact(path, tier="draft", device="cpu")


def test_load_artifact_extra_missing_and_update_merges(
        reference_artifacts, tmp_path):
    assert TDP.load_artifact_extra(str(tmp_path / "nothing")) == {}
    with pytest.raises(FileNotFoundError):
        TDP.update_artifact_extra(str(tmp_path / "nothing"), {"a": 1})
    cfg = TR.get_smoke_config("yi-6b", dtype="float32")
    _, _, ref_path = reference_artifacts["float32"]
    tsp, _ = TDP.load_artifact(ref_path, device="cpu")
    TDP.save_artifact(str(tmp_path), tsp, cfg, extra={"compressed": True})
    TDP.update_artifact_extra(str(tmp_path), {"calibration": [1, 2]})
    TDP.update_artifact_extra(str(tmp_path), {"note": "x"})
    extra = TDP.load_artifact_extra(str(tmp_path))
    assert extra == {"schema": 1, "arch": "yi-6b-smoke", "family": "dense",
                     "n_layers": 2, "tiles": [[16, 16]], "compressed": True,
                     "calibration": [1, 2], "note": "x"}
    assert RDP.load_artifact_extra(str(tmp_path)) == extra
    back, _ = TDP.load_artifact(str(tmp_path), device="cpu")
    _assert_same_serving(back, RDP.load_artifact(ref_path)[0])


def test_two_tier_artifact_shares_leaves_once(reference_artifacts,
                                              tmp_path):
    """The reference's two-tier artifact (a re-pruned draft sharing the
    target's dense leaves by reference): the port boots both tiers, each
    shared leaf one tensor; the port writes it back with those leaves
    once."""
    cfg, rsp, _ = reference_artifacts["float32"]
    draft = RSPEC.draft_serving(cfg, rsp, 0.9)
    ref_dir = str(tmp_path / "ref")
    RDP.save_artifact(ref_dir, rsp, cfg, draft=draft)
    target, tdraft, extra = TDP.load_artifact_tiers(ref_dir, device="cpu")
    assert extra["two_tier"] is True
    _assert_same_serving(target, rsp)
    _assert_same_serving(tdraft, draft)
    assert tdraft.embed is target.embed
    assert tdraft.final_ln is target.final_ln
    for tp, dp in zip(target.layers, tdraft.layers):
        assert dp["ln1"] is tp["ln1"] and dp["ln2"] is tp["ln2"]
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32")
    port_dir = str(tmp_path / "port")
    TDP.save_artifact(port_dir, target, tcfg, draft=tdraft)
    manifests = []
    for d in (ref_dir, port_dir):
        with open(os.path.join(d, "step_00000000", "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0]["n_arrays"] == manifests[1]["n_arrays"]
    assert manifests[1]["spec"] == manifests[0]["spec"]
    t2, d2, _ = TDP.load_artifact_tiers(port_dir, device="cpu")
    assert d2.embed is t2.embed
    _assert_same_serving(d2, draft)


def test_tied_head_is_rebuilt(tmp_path):
    cfg = dataclasses.replace(TR.get_smoke_config("yi-6b", dtype="float32"),
                              tie_embeddings=True)
    params = TT.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    sp = TDP.compress(cfg, params, target_sparsity=0.5, tile=(16, 16))
    assert sp.head is None and sp.head_t is not None
    TDP.save_artifact(str(tmp_path), sp, cfg)
    with open(os.path.join(tmp_path, "step_00000000", "manifest.json")) as f:
        fields = json.load(f)["spec"]["fields"]
    assert fields[3] == fields[4] == fields[5] == {"t": "none"}  # head,
    # mm_proj and the derived head_t are not stored
    back, _ = TDP.load_artifact(str(tmp_path), device="cpu")
    assert torch.equal(back.head_t, back.embed.T)
    assert back.head_t.is_contiguous()
