"""The card-vs-CPU attribution helpers (``repro_torch.serve.parity``) at
smoke size, on the CPU.

The chip run saves its packed yi-6b, boots it on the CPU and compares the
two devices' logits, eq. 5 levels and greedy tokens with these helpers.
Here the same flow runs on one device: a CPU boot of the saved artifact
must give the same levels and logits bit for bit, a perturbation of one
block must show up as level flips that start in that block, and the
counts and the margin rule are checked on made-up records.
"""
import dataclasses

import pytest
import torch

from repro_torch.models import registry as TR
from repro_torch.models.transformer import init_params
from repro_torch.serve import deployed as TDP
from repro_torch.serve import parity as P


@pytest.fixture(scope="module")
def packed():
    cfg = TR.get_smoke_config("yi-6b", dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    sp = TDP.compress(cfg, params, target_sparsity=0.6, tile=(16, 16),
                      uniform=True)
    toks = torch.randint(0, cfg.vocab, (1, 12),
                         generator=torch.Generator().manual_seed(3))
    return cfg, sp, toks


def _run(sp, cfg, toks, next_token=None):
    recs = []
    with P.record_eq5(sp, recs):
        logits = P.prefill_and_step(sp, toks, 10, cfg, next_token)
    return logits, recs


def test_cpu_boot_of_the_artifact_matches_bit_for_bit(packed, tmp_path):
    cfg, sp, toks = packed
    TDP.save_artifact(str(tmp_path / "art"), sp, cfg)
    booted, _ = TDP.load_artifact(str(tmp_path / "art"), device="cpu")
    a, recs_a = _run(sp, cfg, toks)
    nxt = a[:1].argmax(-1, keepdim=True).to(torch.int32)
    b, recs_b = _run(booted, cfg, toks, nxt)
    passes = 7 * cfg.n_layers + 1
    assert len(recs_a) == 2 * passes  # the prefill and the decode step
    assert [n for n, _ in recs_a[:7]] == [
        f"blk0_{p}" for p in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                              "w_down")]
    assert recs_a[passes - 1][0] == "head"
    flips = P.level_flips(recs_a, recs_b)
    assert flips["off_by_one"] == flips["more"] == 0
    assert flips["first"] is None and flips["first_layer"] is None
    assert set(flips["per_projection"]) == set(sp.deployed())
    assert torch.equal(a, b)
    rule = P.greedy_margins(a, b, 2e-2)
    assert rule["equal"] == rule["rows"] == 2 and not rule["faults"]


def test_level_flips_start_in_the_perturbed_block(packed):
    cfg, sp, toks = packed
    layers = [dict(p) for p in sp.layers]
    layers[1]["ln1"] = layers[1]["ln1"] + 0.01
    nudged = dataclasses.replace(sp, layers=layers)
    a, recs_a = _run(sp, cfg, toks)
    nxt = a[:1].argmax(-1, keepdim=True).to(torch.int32)
    _, recs_b = _run(nudged, cfg, toks, nxt)
    flips = P.level_flips(recs_a, recs_b)
    assert flips["first_layer"] == 1 and flips["first"].startswith("blk1_")
    assert flips["off_by_one"] > 0
    for name, e in flips["per_projection"].items():
        if name.startswith("blk0_"):
            assert e["off_by_one"] == e["more"] == 0, name


def test_level_flips_counts_and_order():
    a = [("blk0_wq", torch.tensor([0, 1, 2])),
         ("blk2_w_up", torch.tensor([[5, -3], [1, 1]])),
         ("head", torch.tensor([7]))]
    b = [("blk0_wq", torch.tensor([0, 1, 2])),
         ("blk2_w_up", torch.tensor([[6, -6], [1, 0]])),
         ("head", torch.tensor([8]))]
    got = P.level_flips(a, b)
    assert got["off_by_one"] == 3 and got["more"] == 1
    assert got["first"] == "blk2_w_up" and got["first_layer"] == 2
    assert got["per_projection"]["blk2_w_up"] == {"levels": 4,
                                                  "off_by_one": 2, "more": 1}
    assert got["per_projection"]["blk0_wq"]["off_by_one"] == 0
    with pytest.raises(ValueError):
        P.level_flips(a, b[:2])
    with pytest.raises(ValueError):
        P.level_flips(a[:1], [("blk0_wq", torch.tensor([0, 1]))])


def test_greedy_margins_apply_the_margin_rule():
    ref = torch.tensor([[1.0, 3.0, 2.99],    # margin 0.01, argmax 1
                        [0.0, 1.0, 5.0],     # margin 4.0, argmax 2
                        [2.0, 0.0, 0.0]])    # margin 2.0, argmax 0
    other = torch.tensor([[1.0, 2.9, 3.0],   # differs on a near-tie
                          [0.0, 6.0, 5.0],   # differs on a wide margin
                          [2.0, 0.0, 0.0]])
    got = P.greedy_margins(ref, other, 2e-2)
    assert got["equal"] == 1 and got["rows"] == 3
    assert [r for r, _ in got["differ"]] == [0, 1]
    assert [r for r, _ in got["faults"]] == [1]
    assert got["min_margin"] == pytest.approx(0.01, abs=1e-6)
