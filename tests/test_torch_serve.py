"""The port's compressed serving path, end to end, against the reference.

Model: the smoke yi-6b in float32 with the reference's own parameters and
its own packing (``compress(uniform=True, tile=(16, 16),
target_sparsity=0.6)``), carried across exactly. Logits must agree within
1e-4 absolute: the two frameworks order the f32 sums of attention, norms
and matmuls differently, which moves values by an ulp or so (~1e-7 at
these widths); 1e-4 leaves room for that and still fails on any real
difference, such as an eq. 5 activation landing one level (1/128) apart.
Greedy tokens must equal the reference's; a divergence is accepted only
where the reference's own top-2 logit margin at that step is below that
tolerance. Inside the port, loop = scan, prefix cache on = off and
continuous = static hold bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as RD
from repro.models import registry as RR
from repro.serve import deployed as RDP
from repro.serve import stacked as RST
from repro.serve.batching import Request as RRequest
from repro.serve.server import BatchConfig as RBatchConfig
from repro.serve.server import BatchServer as RBatchServer
from repro_torch import convert
from repro_torch.models import registry as TR
from repro_torch.serve import BatchConfig, BatchServer, Request
from repro_torch.serve import deployed as TDP
from repro_torch.serve import stacked as TST

ATOL = 1e-4
BCFG = dict(n_slots=3, block_size=8, n_blocks=48)


def _export(sp) -> dict:
    """A reference ServingParams as numpy and plain Python."""
    def leaf(v):
        if isinstance(v, RD.DeployedWeight):
            return {"packed": [{k: np.asarray(a) for k, a in p.items()}
                               for p in v.packed],
                    "d_in": v.d_in, "d_out": v.d_out, "bits": v.bits}
        return None if v is None else np.asarray(v)

    return {"embed": leaf(sp.embed), "final_ln": leaf(sp.final_ln),
            "layers": [{k: leaf(v) for k, v in p.items()} for p in sp.layers],
            "head": leaf(sp.head), "head_t": leaf(sp.head_t)}


@pytest.fixture(scope="module")
def models():
    rcfg = RR.get_smoke_config("yi-6b", dtype="float32")
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32")
    params = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    rsp = RDP.compress(rcfg, params, target_sparsity=0.6, tile=(16, 16),
                       uniform=True)
    tsp = convert.serving_params_from_numpy(_export(rsp), tcfg, device="cpu")
    return rcfg, tcfg, rsp, tsp, params


def _trace():
    """5 requests, prompts of 5-20 tokens; r0 and r3 share a 16-token
    (two-block) prefix, so r3 takes the prefix-cache suffix pass."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, 16)
    prompts = [np.concatenate([shared, rng.integers(0, 256, 3)]),
               rng.integers(0, 256, 5), rng.integers(0, 256, 12),
               np.concatenate([shared, rng.integers(0, 256, 4)]),
               rng.integers(0, 256, 9)]
    return [(f"r{i}", p.astype(np.int32), 6 + i % 3)
            for i, p in enumerate(prompts)]


def test_prefill_last_matches_reference(models):
    rcfg, tcfg, rsp, tsp, _ = models
    toks = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(
        np.int32)
    want, wk, wv = jax.jit(RDP.prefill_last, static_argnames=("cfg",))(
        rsp, jnp.asarray(toks), jnp.asarray(13, jnp.int32), cfg=rcfg)
    tsx = TST.stack(tsp)
    got, gk, gv = TDP.prefill_last(tsp, torch.from_numpy(toks), 13, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=0)
    scan = TST.prefill_last(tsx, torch.from_numpy(toks), 13, tcfg)
    for a, b in zip(scan, (got, gk, gv)):
        assert torch.equal(a, b)


def test_decode_and_verify_match_reference(models):
    rcfg, tcfg, rsp, tsp, _ = models
    rng = np.random.default_rng(1)
    shape = (rcfg.n_layers, 3, 24, rcfg.n_kv_heads, rcfg.dh)
    vk = rng.standard_normal(shape).astype(np.float32)
    vv = rng.standard_normal(shape).astype(np.float32)
    pos = np.array([4, 11, 17], np.int32)
    toks = rng.integers(0, 256, (3, 4)).astype(np.int32)
    t = lambda a: torch.from_numpy(a.copy())
    tsx = TST.stack(tsp)
    want = jax.jit(RDP.decode_step_paged, static_argnames=("cfg",))(
        rsp, jnp.asarray(vk), jnp.asarray(vv), jnp.asarray(pos),
        jnp.asarray(toks[:, :1]), cfg=rcfg)
    for sp in (tsp, tsx):
        got = TDP.decode_step_paged(sp, t(vk), t(vv), t(pos), t(toks[:, :1]),
                                    tcfg)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0)
    want = jax.jit(RST.verify_step, static_argnames=("cfg",))(
        RST.stack(rsp), jnp.asarray(vk), jnp.asarray(vv), jnp.asarray(pos),
        jnp.asarray(toks), cfg=rcfg)
    loop = TDP.verify_step(tsp, t(vk), t(vv), t(pos), t(toks), tcfg)
    scan = TST.verify_step(tsx, t(vk), t(vv), t(pos), t(toks), tcfg)
    for g, s, w in zip(loop, scan, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
        assert torch.equal(g, s)


def test_uncompressed_forward_matches_reference(models):
    """Raw (unpacked) weights carried across with ``params_from_numpy``
    take the dense path of ``cim_matmul``; no kernel is involved."""
    rcfg, tcfg, _, _, params = models
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (1, 11)).astype(
        np.int32)
    want, _, _ = jax.jit(RDP.prefill_last, static_argnames=("cfg",))(
        RDP.from_params(rcfg, params), jnp.asarray(toks),
        jnp.asarray(11, jnp.int32), cfg=rcfg)
    for sp in (TDP.from_params(tcfg, tparams),
               TST.stack(TDP.from_params(tcfg, tparams))):
        got, _, _ = TDP.prefill_last(sp, torch.from_numpy(toks), 11, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def _ref_margin(rsp, rcfg, seq) -> float:
    """The reference's top-2 logit margin after consuming ``seq``."""
    logits, _, _ = RDP.prefill_last(rsp, jnp.asarray(seq)[None],
                                    jnp.asarray(len(seq), jnp.int32), rcfg)
    top = np.sort(np.asarray(logits)[0])[-2:]
    return float(top[1] - top[0])


def test_batch_server_tokens_match_reference(models):
    rcfg, tcfg, rsp, tsp, _ = models
    trace = _trace()
    ref = RBatchServer(rcfg, rsp, bcfg=RBatchConfig(**BCFG), engine="scan")
    want = ref.run([RRequest(r, p, n) for r, p, n in trace]).outputs
    runs = {}
    for engine in ("scan", "loop"):
        for prefix in (True, False):
            srv = BatchServer(tcfg, tsp, engine=engine, device="cpu",
                              bcfg=BatchConfig(prefix_cache=prefix, **BCFG))
            rep = srv.run([Request(r, p, n) for r, p, n in trace])
            runs[(engine, prefix)] = rep
    rep = runs[("scan", True)]
    assert rep.prefix["hits"] >= 1  # the suffix pass ran
    assert rep.n_requests == len(trace)
    margins = []
    for rid, prompt, _ in trace:
        got, exp = rep.outputs[rid], want[rid]
        assert got.shape == exp.shape
        bad = np.flatnonzero(got != exp)
        if bad.size:  # only a near-tie in the reference may flip a token
            step = int(bad[0])
            seq = np.concatenate([prompt, exp[:step]]).astype(np.int32)
            margins.append((rid, step, _ref_margin(rsp, rcfg, seq)))
    print("divergences (rid, step, reference top-2 margin):", margins)
    assert all(m < ATOL for _, _, m in margins), margins
    for key, other in runs.items():
        for rid in rep.outputs:
            np.testing.assert_array_equal(other.outputs[rid],
                                          rep.outputs[rid], err_msg=str(key))
    static = BatchServer(tcfg, tsp, engine="scan", device="cpu",
                         continuous=False, bcfg=BatchConfig(**BCFG))
    srep = static.run([Request(r, p, n) for r, p, n in trace])
    for rid in rep.outputs:
        np.testing.assert_array_equal(srep.outputs[rid], rep.outputs[rid])


def test_sample_tokens_greedy_and_distribution():
    """Greedy sampling is the reference's argmax; temperature sampling
    cannot follow JAX's PRNG stream, so it is held to its distribution."""
    from repro.serve.engine import ServeConfig as RServeConfig
    from repro.serve.engine import sample_tokens as r_sample
    from repro_torch.serve import ServeConfig, sample_tokens
    logits = np.random.default_rng(3).standard_normal((4, 7)).astype(
        np.float32)
    want = r_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                    RServeConfig())
    got = sample_tokens(torch.from_numpy(logits), None, ServeConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    row = torch.from_numpy(logits[:1]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = sample_tokens(row, gen, ServeConfig(temperature=0.7))
    freq = torch.bincount(draws.long(), minlength=7).double() / 20000
    p = torch.softmax(torch.from_numpy(logits[0]).double() / 0.7, -1)
    # 20000 draws: a frequency's standard error is at most ~0.0035
    assert float((freq - p).abs().max()) < 0.02


def test_batch_server_defaults_to_cuda(models, monkeypatch):
    """No device means cuda: without a GPU the server raises, it never
    falls back to the CPU on its own."""
    _, tcfg, _, tsp, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchServer(tcfg, tsp)
    with pytest.raises(NotImplementedError):
        BatchServer(tcfg, tsp, device="cpu", engine="spec")
    with pytest.raises(NotImplementedError):
        BatchServer(tcfg, tsp, device="cpu", tracer=object())
