"""The port's dry run (``launch/dryrun.py``, ``launch/mesh.py``).

The pure functions (``input_specs``, ``active_param_count``,
``model_flops``, ``OPT_OVERRIDES``, ``_pattern_period``, ``_reduced``) are
held equal to the reference's for every architecture and shape. The
DTensor program runs in ONE subprocess, since torch's fake process group
is process-global: a smoke cell of each family on a (2, 2) fake mesh (its
batch and sequence cut; PASS, or a FAIL that names an op), the per-device
FLOPs of the dense smoke train step against the unsharded count divided by
the chips, the collective bytes of a hand-built two-collective program
(exact), the --opt train cells of yi-6b and llava-next-34b against the
same cells with ``seq_shard_residual`` off (at smoke size, and yi-6b at
16x16 on the production mesh), and the CLI on smoke configs over a (2, 2)
fake mesh with a failing cell in the sweep. Nothing here touches a card.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import dryrun as D
from repro_torch.models import registry as TR
from repro_torch.models.config import SHAPES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAM = r'''
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import dryrun as D, mesh as M
from repro_torch.models import registry
from repro_torch.models.config import SHAPES
from repro_torch.train import optimizer as optim
from repro_torch.train.trainer import TrainConfig, make_train_step, train_state

out = {}
mesh = M.make_fake_mesh((2, 2), ("data", "model"))
cut = lambda k: dataclasses.replace(SHAPES[k], seq_len=min(SHAPES[k].seq_len,
                                                           128),
                                    global_batch=4)
# (the dense train step runs below, in the FLOP count)
for arch, kind in [("yi-6b", "decode_32k"), ("phi3.5-moe-42b-a6.6b",
                                             "prefill_32k"),
                   ("mamba2-780m", "prefill_32k"),
                   ("zamba2-1.2b", "decode_32k"),
                   ("whisper-tiny", "prefill_32k"),
                   ("llava-next-34b", "decode_32k")]:
    cfg = registry.get_smoke_config(arch)
    try:
        rec = D.run_cell(arch, kind, mesh, cfg=cfg, shape=cut(kind),
                         with_roofline=False)
        out[arch] = ["PASS", sorted(rec)]
    except D.CellFailed as e:
        out[arch] = ["FAIL", e.op]

# the depthwise conv's rule forward and backward (mamba2's train step)
cfg = registry.get_smoke_config("mamba2-780m")
try:
    D.run_cell("mamba2-780m", "train_4k", mesh, cfg=cfg,
               shape=cut("train_4k"), with_roofline=False)
    out["mamba2 train"] = ["PASS", None]
except D.CellFailed as e:
    out["mamba2 train"] = ["FAIL", e.op]

# --opt train cells (the Megatron-SP constraint) against the same cells
# with seq_shard_residual off: local FLOPs and collective bytes
def opt_bar(arch, cfg, shape, mesh, depth_terms=False):
    row = []
    on = D.cell_config(arch, opt=True, cfg=cfg)
    for c in (on, dataclasses.replace(on, seq_shard_residual=False)):
        r = (D.cost_terms if depth_terms else D.measure)(c, shape, mesh, True)
        row.append([r["flops"], r["coll"]])
    return row
out["opt_bar"] = {f"{arch} 2x2": opt_bar(arch, registry.get_smoke_config(
    arch), cut("train_4k"), mesh) for arch in ("yi-6b", "llava-next-34b")}
out["opt_keys"] = [sorted(D.run_cell(
    "yi-6b", "train_4k", mesh, cfg=registry.get_smoke_config("yi-6b"),
    shape=cut("train_4k"), with_roofline=False, opt=o)) for o in (True,
                                                                  False)]

# the rules on values: rank 0's shards of real CPU tensors (no
# collective runs: the layouts given need none)
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
g = torch.Generator().manual_seed(0)
xf = torch.randn(4, 6, 10, generator=g, requires_grad=True)
wf = torch.randn(6, 1, 3, generator=g, requires_grad=True)
bf = torch.randn(6, generator=g, requires_grad=True)
yf = torch.nn.functional.conv1d(xf, wf, bf, groups=6)
dyf = torch.randn(yf.shape, generator=g)
dxf, dwf, dbf = torch.autograd.grad(yf, (xf, wf, bf), dyf)
pl = lambda d: ["S%d" % p.dim if p.is_shard() else "P" if p.is_partial()
                 else "R" for p in d.placements]
dt = lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=None, stride=None)
x = dt(xf.detach()[:2, :3].clone(), [Shard(0), Shard(1)]).requires_grad_()
w = dt(wf.detach()[:3].clone(), [Replicate(), Shard(0)]).requires_grad_()
b = dt(bf.detach()[:3].clone(), [Replicate(), Shard(0)]).requires_grad_()
with D.dryrun_rules():
    y = torch.nn.functional.conv1d(x, w, b, groups=6)
    dy = dt(dyf[:2, :3].clone(), [Shard(0), Shard(1)])
    dx, dw, db = torch.autograd.grad(y, (x, w, b), dy)
# rank 0 holds batch 0:2 of channels 0:3; its weight gradient is its own
# batch's part of the sum over the data axis
part = torch.nn.functional.conv1d(xf[:2], wf, bf, groups=6)
pdx, pdw, pdb = torch.autograd.grad(part, (xf, wf, bf), dyf[:2])
out["conv"] = [
    torch.equal(y.to_local(), yf.detach()[:2, :3]),
    pl(y),
    torch.allclose(dx.to_local(), dxf[:2, :3]),
    torch.allclose(dw.to_local(), pdw[:3]),
    torch.allclose(db.to_local(), pdb[:3]),
    pl(dw)]
# a view that splits 3 heads out of a dim sharded over 2: refused by
# DTensor, run by the rule on the dim gathered (one all-gather counted)
h = dt(torch.zeros(2, 4, 6), [Shard(0), Shard(2)])
counter = D.CostCounter()
with counter, D.dryrun_rules():
    v = h.reshape(4, 4, 3, 4)
out["view"] = [list(v.shape), pl(v),
               dict(counter.coll_counts)]

# per-device FLOPs of the dense train step against the unsharded count
cfg = registry.get_smoke_config("yi-6b")
shape = cut("train_4k")
tcfg = TrainConfig(opt=optim.OptConfig(kind="adamw", clip_norm=1.0))
state = train_state(tcfg, D._params_shape(cfg))
batch = {k: torch.zeros(v.shape, dtype=v.dtype, device="meta")
         for k, v in D.input_specs(cfg, shape).items()}
with FlopCounterMode(display=False) as fc:
    make_train_step(cfg, tcfg)(state, batch)
out["flops"] = [D.measure(cfg, shape, mesh)["flops"], fc.get_total_flops()]

# two collectives by hand: an all-gather over data and an all-reduce over
# model, each of an (8, 8) f32 result
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                       [Shard(0), Replicate()], run_check=False,
                       shape=(8, 8), stride=(8, 1))
y = DTensor.from_local(torch.empty(8, 8, device="meta"), mesh,
                       [Replicate(), Partial()], run_check=False,
                       shape=(8, 8), stride=(8, 1))
counter = D.CostCounter()
with counter:
    x.redistribute(mesh, [Replicate(), Replicate()])
    y.redistribute(mesh, [Replicate(), Replicate()])
out["coll"] = [counter.coll, counter.coll_counts]
dist.destroy_process_group()

# the --opt bar at 16x16: full-width yi-6b, its depth extrapolated from one
# and two layers (the sweep's cost terms)
mesh = M.make_production_mesh()
out["opt_bar"]["yi-6b 16x16"] = opt_bar(
    "yi-6b", registry.get_config("yi-6b"), SHAPES["train_4k"], mesh, True)
dist.destroy_process_group()

# the CLI over fake meshes, smoke configs, a failing cell in the sweep
registry.get_config = registry.get_smoke_config
registry.supported_cells = lambda arch: ["train_4k", "no_such_shape"]
D.make_production_mesh = lambda multi_pod=False: M.make_fake_mesh(
    (2, 2), ("data", "model"))
D.SHAPES["train_4k"] = cut("train_4k")
out["cli"] = D.main(["--arch", "yi-6b", "--multi-pod", "single",
                     "--no-roofline", "--out", sys.argv[1]])
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun") / "cli.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", PROGRAM, path],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT "))
    with open(path) as f:
        cli = json.load(f)
    return json.loads(line[len("RESULT "):]), r.stdout, cli


def test_smoke_cell_of_each_family(program):
    out, _, _ = program
    for arch in ("yi-6b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                 "zamba2-1.2b", "whisper-tiny", "llava-next-34b"):
        verdict, detail = out[arch]
        if verdict == "FAIL":  # a failure names the aten op
            assert detail.startswith("aten.") or "DTensor" in detail
        else:
            assert {"argument_bytes_per_dev", "temp_bytes_per_dev",
                    "peak_bytes_per_dev", "compile_s"} <= set(detail)
    assert out["yi-6b"][0] == "PASS"


def test_per_device_flops_against_unsharded_over_chips(program):
    """The local count is at least the unsharded count over the 4 chips,
    and above it only by the products the sharding leaves replicated on
    some mesh dim (under 10% in the dense smoke step)."""
    per_dev, total = program[0]["flops"]
    assert total > 0
    assert 1.0 <= per_dev * 4 / total < 1.1


def test_conv_train_step_runs_sharded_by_channel(program):
    """mamba2's train step: the depthwise conv and its backward take the
    dry run's channel rule."""
    assert program[0]["mamba2 train"] == ["PASS", None]


# the head's input gathered (B / data, S, D) and its gradient
# reduce-scattered back (a model-th of it), in bytes
def _head_allowance(cfg, shape, data_n, model_n):
    s = shape.seq_len - (cfg.n_patches if cfg.family == "vlm" else 0)
    gathered = (shape.global_batch // data_n) * s * cfg.d_model * (
        torch.finfo(getattr(torch, cfg.dtype)).bits // 8)
    return gathered * (1 + 1 / model_n)


OPT_CELLS = {"yi-6b 2x2": ("yi-6b", True, 2),
             "llava-next-34b 2x2": ("llava-next-34b", True, 2),
             "yi-6b 16x16": ("yi-6b", False, 16)}


@pytest.mark.parametrize("cell", sorted(OPT_CELLS))
def test_opt_flops_are_those_of_the_cell_without_the_sequence_shard(
        program, cell):
    """An --opt train cell (``seq_shard_residual``: the residual stream
    sharded by sequence between layers) counts no more than 1.01 x the
    local FLOPs of the same cell with the flag off: the dry run's rules
    give it Megatron-SP's layout (the sequence gathered before the
    column-parallel products, the head vocabulary-sharded, the attention
    sharded by heads), where DTensor alone computed the head with the
    whole vocabulary on every device."""
    (f_opt, _), (f_off, _) = program[0]["opt_bar"][cell]
    assert 0 < f_opt <= 1.01 * f_off, (cell, f_opt / f_off)


@pytest.mark.parametrize("cell", sorted(OPT_CELLS))
def test_opt_collectives_exceed_the_cell_without_the_sequence_shard_by_the_head_only(
        program, cell):
    """Its collective bytes exceed that cell's by at most the head input's
    all-gather and its gradient's reduce-scatter."""
    (_, c_opt), (_, c_off) = program[0]["opt_bar"][cell]
    arch, smoke, n = OPT_CELLS[cell]
    cfg = D.cell_config(arch, opt=True, cfg=(TR.get_smoke_config(arch)
                                             if smoke else None))
    shape = SHAPES["train_4k"]
    if smoke:  # the program's cut
        shape = dataclasses.replace(shape, seq_len=128, global_batch=4)
    assert c_off > 0
    assert c_opt <= c_off + _head_allowance(cfg, shape, n, n), (
        cell, c_opt, c_off)


def test_opt_records_have_the_reference_keys(program):
    """An --opt record has the keys of a baseline record, the reference's,
    and nothing that marks it apart."""
    opt_keys, keys = program[0]["opt_keys"]
    assert opt_keys == keys
    assert "comparable_to_baseline" not in keys


def test_dryrun_rules_on_values(program):
    """The rules against the unsharded ops on real CPU values: the
    depthwise conv's output and input gradient are rank 0's slices, its
    weight and bias gradients rank 0's batch's part (Partial over the data
    axis); the refused view runs on the gathered dim."""
    same_y, y_pl, same_dx, same_dw, same_db, dw_pl = program[0]["conv"]
    assert same_y and same_dx and same_dw and same_db
    assert y_pl == ["S0", "S1"]
    assert dw_pl == ["P", "S0"]
    shape, placements, counts = program[0]["view"]
    assert shape == [4, 4, 3, 4]
    assert placements == ["S0", "R"]
    assert counts["all-gather"] == 1


def test_collective_bytes_exact(program):
    coll, counts = program[0]["coll"]
    assert counts == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 0,
                      "all-to-all": 0, "collective-permute": 0}
    # result bytes x the wire factor: 256 B gathered, 256 B reduced x 2
    assert coll == {"all-reduce": 512.0, "all-gather": 256.0,
                    "reduce-scatter": 0.0, "all-to-all": 0.0,
                    "collective-permute": 0.0}


def test_cli_keeps_sweeping_and_exits_1(program):
    out, stdout, cli = program
    assert out["cli"] == 1
    passes = [ln for ln in stdout.splitlines() if ln.startswith("PASS")]
    fails = [ln for ln in stdout.splitlines() if ln.startswith("FAIL")]
    assert len(passes) == 1 and len(fails) == 1
    assert passes[0].startswith("PASS yi-6b x train_4k x 2x2 ")
    assert fails[0].startswith("FAIL yi-6b x no_such_shape x 2x2")
    (r,) = cli["results"]
    assert r["mesh"] == "2x2" and r["temp_bytes_per_dev"] > 0
    assert r["peak_bytes_per_dev"] == (r["argument_bytes_per_dev"]
                                       + r["temp_bytes_per_dev"])
    assert len(cli["failures"]) == 1


def _reference():
    """The reference's dryrun module, its XLA_FLAGS side effect undone."""
    pytest.importorskip("jax")
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as RD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return RD


def test_pure_functions_match_reference():
    """Every architecture, and four with the overrides (whose head
    padding, split layout and vocab padding change the shapes); the FLOP
    formulas at every shape of yi-6b, the batch specs also for the
    families whose batches differ."""
    RD = _reference()
    from repro.models import registry as RR
    assert D.OPT_OVERRIDES == RD.OPT_OVERRIDES
    for arch in RR.ARCH_IDS:
        # the overrides change the shapes of these: split mamba layouts,
        # padded heads (whisper 6, llava 56) and a padded vocab
        opt = arch in ("mamba2-780m", "whisper-tiny", "llava-next-34b",
                       "yi-6b")
        for over in ({}, D.OPT_OVERRIDES) if opt else ({},):
            rcfg, tcfg = RR.get_config(arch, **over), TR.get_config(arch,
                                                                    **over)
            assert math.isclose(D.active_param_count(tcfg),
                                RD.active_param_count(rcfg), rel_tol=1e-12)
            assert D._pattern_period(tcfg) == RD._pattern_period(rcfg)
            for n in (1, 2, 6):
                r, t = RD._reduced(rcfg, n), D._reduced(tcfg, n)
                assert (t.n_layers, t.scan_unroll, t.enc_layers) == (
                    r.n_layers, r.scan_unroll, r.enc_layers)
    for arch in ("yi-6b", "whisper-tiny", "llava-next-34b",
                 "phi3.5-moe-42b-a6.6b"):
        rcfg, tcfg = RR.get_config(arch), TR.get_config(arch)
        for name in SHAPES:
            if arch == "yi-6b":
                assert math.isclose(D.model_flops(tcfg, SHAPES[name]),
                                    RD.model_flops(rcfg, RD.SHAPES[name]),
                                    rel_tol=1e-12)
            want = RD.input_specs(rcfg, RD.SHAPES[name])
            got = D.input_specs(tcfg, SHAPES[name])
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype).split(".")[-1] == str(
                    want[k].dtype)
                assert got[k].device.type == "meta"


def test_cell_config_and_roofline_constants():
    cfg = D.cell_config("yi-6b", cim=True, opt=True)
    assert cfg.cim_mode == "qat" and cfg.seq_shard_residual
    assert cfg.attn_chunk == 1024 and cfg.ssd_lowp
    moe = D.cell_config("phi3.5-moe-42b-a6.6b", opt=True)
    assert not moe.seq_shard_residual  # refuted for moe in the reference
    # the card's data-sheet peaks, no TPU number
    assert (D.PEAK_FLOPS, D.HBM_BW, D.LINK_BW) == (989e12, 3.35e12, 50e9)


def test_kernel_wrappers_take_plain_versions_on_meta():
    from repro_torch.kernels import fake_quant as FQ
    from repro_torch.kernels import grouped_matmul as GM
    from repro_torch.kernels import ssd_intra as SI
    x = torch.empty(4, 8, device="meta")
    assert FQ.fake_quant(x, 8).device.type == "meta"
    y = GM.grouped_matmul(torch.empty(2, 3, 8, device="meta"),
                          torch.empty(2, 8, 5, device="meta"))
    assert tuple(y.shape) == (2, 3, 5) and y.device.type == "meta"
    a = torch.empty(2, 2, 16, device="meta")
    b = torch.empty(2, 16, 4, device="meta")
    xx = torch.empty(2, 16, 2, 8, device="meta")
    assert SI.ssd_intra_chunk(a, b, b, xx).device.type == "meta"


def test_dry_run_refuses_an_older_torch(monkeypatch, capsys):
    """Below REQUIRED_TORCH the CLI refuses (exit 2, naming the version it
    needs) before it makes a process group; the installed torch passes
    the check, its DTensor internals present."""
    D.check_torch()
    monkeypatch.setattr(torch, "__version__", "2.11.0+cu128")
    with pytest.raises(RuntimeError, match=r"needs torch >= 2\.13"):
        D.check_torch()
    assert D.main(["--arch", "yi-6b", "--shape", "train_4k"]) == 2
    assert "needs torch >= 2.13" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()
