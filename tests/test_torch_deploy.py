"""The port's packing against the reference's.

Two bars. A packing carried across from the reference is served exactly.
The port's OWN ``compress`` of the same float weights must give identical
prune masks (so ``row_idx``, ``nnz`` and scales are identical), but its int8
levels may differ from the reference's by one level where eq. 8's pre-rounding
value ``w_bar * (2^(b-1) - 1)`` sits on a half-level: ``torch.tanh`` and
XLA's ``tanh`` differ by an ulp, and half-to-even rounding then breaks the
other way. At most 1 level in 1e5 may differ, each by +-1, and only there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as RD
from repro.core import quant as RQ
from repro.core import sparsity as RS
from repro.core.mapping import bsr_to_dense as r_bsr_to_dense
from repro.core.mapping import pack_bsr as r_pack_bsr
from repro.models import registry as RR
from repro.serve import deployed as RDP
from repro_torch import convert
from repro_torch.core import deploy as TD
from repro_torch.core.mapping import BsrWeight, bsr_to_dense, pack_bsr
from repro_torch.models import registry as TR
from repro_torch.serve import deployed as TDP

KEYS = ("blocks", "scales", "row_idx", "nnz")
TILE, SPARSITY = (16, 16), 0.6


def _levels(p, dw) -> np.ndarray:
    """Dense (d_in, d_out) int levels of a single-layer packed dict."""
    a = {k: np.asarray(p[k]) for k in KEYS}
    bk, bn = a["blocks"].shape[2:]
    return bsr_to_dense(BsrWeight(a["blocks"], a["row_idx"], a["nnz"], bk,
                                  bn, dw.d_in, dw.d_out))


def _carry(dw) -> TD.DeployedWeight:
    """A reference DeployedWeight as the port's, arrays copied exactly."""
    return TD.DeployedWeight(
        [{k: (float(v) if k == "density" else torch.from_numpy(np.array(v)))
          for k, v in p.items()} for p in dw.packed],
        dw.d_in, dw.d_out, dw.bits)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def compressed(request):
    """The smoke yi-6b packed by the reference and by the port, from the
    same master weights in the config's dtype."""
    rcfg = RR.get_smoke_config("yi-6b", dtype=request.param)
    tcfg = TR.get_smoke_config("yi-6b", dtype=request.param)
    params = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    rsp = RDP.compress(rcfg, params, target_sparsity=SPARSITY, tile=TILE,
                       uniform=True)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    tsp = TDP.compress(tcfg, tparams, target_sparsity=SPARSITY, tile=TILE,
                       uniform=True)
    return rcfg, params, rsp, tsp


def _pre_rounding(w, cim, ts, bk, bn) -> np.ndarray:
    """The reference's eq. 8 input times (2^(b-1)-1), in the master dtype."""
    w = jnp.asarray(w)
    mask = RS.prune_mask_2d(w, bk, bn, ts)
    w_bar = RQ.fuse_bn_scale(RQ.tanh_normalize(w * mask,
                                               cim.quant.group_size),
                             None, None)
    qmax = 2.0 ** (cim.quant.w_bits - 1) - 1.0
    return np.asarray(w_bar * qmax).astype(np.float64)


def _level_diffs(rdw, tdw, pre) -> list:
    """(level difference, distance of the reference's pre-rounding value
    from a half-level) at every level where the two packings differ."""
    lr, lt = _levels(rdw.packed[0], rdw), _levels(tdw.packed[0], tdw)
    return [(int(lr[i, j]) - int(lt[i, j]),
             abs(pre[i, j] - np.floor(pre[i, j]) - 0.5))
            for i, j in zip(*np.nonzero(lr != lt))]


def _assert_level_rule(diffs, n_levels) -> None:
    assert len(diffs) <= max(1, n_levels // 100_000), diffs
    for d, off_half in diffs:
        assert abs(d) == 1 and off_half <= 1e-4, (d, off_half)


def test_compress_matches_reference(compressed):
    rcfg, params, rsp, tsp = compressed
    rdep, tdep = rsp.deployed(), tsp.deployed()
    assert sorted(rdep) == sorted(tdep)
    n_levels, diffs = 0, []
    for name, rdw in rdep.items():
        tdw = tdep[name]
        assert (tdw.d_in, tdw.d_out, tdw.bits, tdw.tile) == (
            rdw.d_in, rdw.d_out, rdw.bits, rdw.tile)
        rp, tp = rdw.packed[0], tdw.packed[0]
        for k in ("row_idx", "nnz", "scales"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(rp[k]),
                                          err_msg=f"{name}.{k}")
        rb, tb = np.asarray(rp["blocks"]), tp["blocks"].numpy()
        assert rb.shape == tb.shape
        n_levels += rb.size
        if (rb != tb).any():
            layer = None if name == "head" else int(name[3:name.index("_")])
            w = (params["head"] if layer is None
                 else params["layers"][name[name.index("_") + 1:]][layer])
            pre = _pre_rounding(w, rcfg.cim, SPARSITY, *rdw.tile)
            diffs += _level_diffs(rdw, tdw, pre)
    _assert_level_rule(diffs, n_levels)


def test_stack_deployed_matches_reference(compressed):
    """Stacking the reference's own packing gives the reference's envelope."""
    _, _, rsp, _ = compressed
    for proj in ("wq", "wk", "w_down"):
        rdws = [p[proj] for p in rsp.layers]
        rsw = RD.stack_deployed(rdws)
        tsw = TD.stack_deployed([_carry(dw) for dw in rdws])
        for k in KEYS:
            np.testing.assert_array_equal(getattr(tsw, k).numpy(),
                                          np.asarray(getattr(rsw, k)))
        assert tsw.tile == rsw.tile and tsw.density == pytest.approx(
            rsw.density)
        back = tsw.layer(1)
        for k in KEYS:
            np.testing.assert_array_equal(back.packed[0][k].numpy(),
                                          np.asarray(rsw.layer(1).packed[0][k]))


def test_deploy_weight_levels_on_a_larger_weight():
    """deploy_weight alone on a 256x512 f32 and bf16 weight (131k levels)."""
    rng = np.random.default_rng(11)
    w32 = (rng.standard_normal((256, 512)) * 0.05).astype(np.float32)
    cim = TR.get_smoke_config("yi-6b").cim
    rcim = RR.get_smoke_config("yi-6b").cim
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        wj = jnp.asarray(w32, dt_j)
        rdw = RD.deploy_weight(wj, rcim, bk=32, bn=64, target_sparsity=0.5)
        tdw = TD.deploy_weight(torch.from_numpy(w32).to(dt_t), cim, bk=32,
                               bn=64, target_sparsity=0.5)
        rp, tp = rdw.packed[0], tdw.packed[0]
        for k in ("row_idx", "nnz", "scales"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(rp[k]))
        pre = _pre_rounding(wj, rcim, 0.5, 32, 64)
        _assert_level_rule(_level_diffs(rdw, tdw, pre), w32.size)


def test_deployed_and_stacked_matmul_match_reference(compressed):
    """The compressed projection on the carried-across packing, against the
    reference's deployed_matmul (Pallas interpret), and stacked == single
    inside the port."""
    rcfg, _, rsp, _ = compressed
    rdws = [p["w_gate"] for p in rsp.layers]
    tdws = [_carry(dw) for dw in rdws]
    tsw = TD.stack_deployed(tdws)
    x = np.random.default_rng(2).standard_normal((3, 5, 64)).astype(
        np.float32)
    for i, (rdw, tdw) in enumerate(zip(rdws, tdws)):
        want = np.asarray(RD.deployed_matmul(jnp.asarray(x), rdw, a_bits=8,
                                             interpret=True))
        got = TD.deployed_matmul(torch.from_numpy(x), tdw, a_bits=8)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        st = TD.stacked_matmul(torch.from_numpy(x), tsw,
                               torch.tensor([i], dtype=torch.int32), a_bits=8)
        assert torch.equal(st, got)
    # a bf16 input comes back f32: x is rebound to the quantized activation
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert TD.deployed_matmul(xb, tdws[0], a_bits=8).dtype == torch.float32


def test_report_matches_reference(compressed):
    _, _, rsp, tsp = compressed
    r, t = rsp.report(), tsp.report()
    assert t == pytest.approx(r)


@pytest.mark.parametrize("nnz_max", [None, 2])
def test_pack_bsr_roundtrip_and_reference(nnz_max):
    rng = np.random.default_rng(4)
    keep = rng.random((6, 5)) < 0.5
    w = rng.integers(-127, 128, (96, 80)).astype(np.int8) * np.repeat(
        np.repeat(keep, 16, 0), 16, 1).astype(np.int8)
    bw = pack_bsr(w, 16, 16, nnz_max=nnz_max)
    rbw = r_pack_bsr(w, 16, 16, nnz_max=nnz_max)
    for k in ("blocks", "row_idx", "nnz"):
        np.testing.assert_array_equal(getattr(bw, k), getattr(rbw, k))
    np.testing.assert_array_equal(bsr_to_dense(bw), r_bsr_to_dense(rbw))
    if nnz_max is None:
        np.testing.assert_array_equal(bsr_to_dense(bw), w)
    assert bw.density == pytest.approx(rbw.density)
