"""The moe family (phi3.5-moe, grok-1) in the port against the reference,
and the grouped-product kernel its router and experts run on.

Smoke configs in float32, inputs and weights from numpy seeds or the
reference's own parameters and packing (``compress(uniform=True, tile=(16,
16), target_sparsity=0.6)``), carried across exactly by ``convert``. The
bars:

* ``moe_block``: y and the aux loss within 1e-5 of the reference's
  (``tests/test_kernels.py``'s f32 tolerance; the frameworks order f32
  sums differently), the top-k experts and the drop mask equal;
* the reference's own moe properties (``expert_split`` exact, the token
  group size free at a large capacity) hold in the port, and a length the
  group size does not divide is refused, as the reference's reshape
  refuses it;
* greedy tokens equal the reference's through ``Engine`` and
  ``BatchServer`` (loop, scan, spec; prefix cache on and off), a token
  being allowed to differ only where the reference's own top-2 logit
  margin at that step is below ATOL (``serve/parity.py``'s rule);
* inside the port, verify = T one-token steps and loop = scan = spec, bit
  for bit.

The two ``cuda`` cases hold the kernel against its plain version and its
rows bit for bit across row counts; they skip without a card. JAX is
imported inside the tests that compare against it: the GPU machine has
none.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.kernels import grouped_matmul as GM
from repro_torch.models import layers as TL
from repro_torch.models import registry as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchConfig, BatchServer, Request
from repro_torch.serve import deployed as TDP
from repro_torch.serve import spec as TSP
from repro_torch.serve import stacked as TST
from repro_torch.serve.engine import Engine, ServeConfig

MOE = ("phi3.5-moe-42b-a6.6b", "grok-1-314b")
TOL = 1e-5  # tests/test_kernels.py's f32 tolerance
ATOL = 1e-4  # the margin rule's logit tolerance (tests/test_torch_serve.py)
BCFG = dict(n_slots=3, block_size=8, n_blocks=64)


def _ref():
    """The reference's modules (JAX is imported here, not at the top)."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers, registry
    from repro.serve import deployed, spec, stacked
    from repro.serve.batching import Request as RRequest
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import ServeConfig as RServeConfig
    from repro.serve.server import BatchConfig as RBatchConfig
    from repro.serve.server import BatchServer as RBatchServer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, L=layers, R=registry, DP=deployed, SP=spec,
        ST=stacked, Request=RRequest, Engine=REngine,
        ServeConfig=RServeConfig, BatchConfig=RBatchConfig,
        BatchServer=RBatchServer)


def _export(sp) -> dict:
    """A reference ServingParams as numpy and plain Python."""
    def leaf(v):
        if hasattr(v, "packed"):
            return {"packed": [{k: np.asarray(a) for k, a in p.items()}
                               for p in v.packed],
                    "d_in": v.d_in, "d_out": v.d_out, "bits": v.bits}
        return None if v is None else np.asarray(v)

    return {"embed": leaf(sp.embed), "final_ln": leaf(sp.final_ln),
            "layers": [{k: leaf(v) for k, v in p.items()} for p in sp.layers],
            "head": leaf(sp.head), "head_t": leaf(sp.head_t)}


@pytest.fixture(scope="module", params=MOE)
def model(request):
    """(arch, rcfg, tcfg, reference params, port params, reference
    packing, port packing) of one moe smoke config."""
    R = _ref()
    arch = request.param
    rcfg = R.R.get_smoke_config(arch, dtype="float32")
    tcfg = TR.get_smoke_config(arch, dtype="float32")
    params = R.R.model_fns(rcfg).init_params(rcfg, R.jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        R.jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rsp = R.DP.compress(rcfg, params, target_sparsity=0.6, tile=(16, 16),
                        uniform=True)
    tsp = convert.serving_params_from_numpy(_export(rsp), tcfg, device="cpu")
    return arch, rcfg, tcfg, params, tparams, rsp, tsp


def _moe_weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    e, d, ff, sp = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.expert_split
    return {"router": rng.standard_normal((d, e), np.float32) * 0.5,
            "w_gate": rng.standard_normal((e * sp, d, ff // sp),
                                          np.float32) * 0.1,
            "w_up": rng.standard_normal((e * sp, d, ff // sp),
                                        np.float32) * 0.1,
            "w_down": rng.standard_normal((e * sp, ff // sp, d),
                                          np.float32) * 0.1}


def _reference_routing(R, p, x, cfg, monkeypatch):
    """The reference's moe_block with its top-k and slot one-hot recorded:
    (y, aux, top-k indices, keep mask)."""
    seen = {}
    top_k, one_hot = R.jax.lax.top_k, R.jax.nn.one_hot

    def rec_top_k(a, k):
        out = top_k(a, k)
        seen["idx"] = np.asarray(out[1])
        return out

    def rec_one_hot(a, n, **kw):
        seen.setdefault("one_hot", []).append((np.asarray(a), n))
        return one_hot(a, n, **kw)

    monkeypatch.setattr(R.jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(R.jax.nn, "one_hot", rec_one_hot)
    y, aux = R.L.moe_block({k: R.jnp.asarray(v) for k, v in p.items()},
                           R.jnp.asarray(x), cfg)
    monkeypatch.undo()
    slot, cap = seen["one_hot"][1]
    return np.asarray(y), float(aux), seen["idx"], slot < cap


@pytest.mark.parametrize("arch,over", [
    ("phi3.5-moe-42b-a6.6b", {}),
    ("grok-1-314b", {"expert_split": 2}),
    ("phi3.5-moe-42b-a6.6b", {"moe_group_size": 8}),
    ("phi3.5-moe-42b-a6.6b", {"cim_mode": "qat"}),
    ("grok-1-314b", {"capacity_factor": 0.5}),
], ids=["phi", "grok-split2", "phi-groups8", "phi-qat", "grok-cap0.5"])
def test_moe_block_matches_reference(arch, over, monkeypatch):
    """y, aux, routing and drops at one-token steps (s = 1, several rows),
    short and long sequences; the drops past capacity are exercised."""
    R = _ref()
    rcfg = R.R.get_smoke_config(arch, dtype="float32", **over)
    tcfg = TR.get_smoke_config(arch, dtype="float32", **over)
    p = _moe_weights(rcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(1)
    dropped = 0
    for b, s in ((1, 1), (3, 1), (2, 8), (1, 32), (2, 16)):
        x = rng.standard_normal((b, s, rcfg.d_model), np.float32) * 0.5
        y, aux, idx, keep = _reference_routing(R, p, x, rcfg, monkeypatch)
        ty, taux = TL.moe_block(tp, torch.from_numpy(x), tcfg)
        rt = TL.moe_route(tp, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(ty.numpy(), y, atol=TOL, rtol=0)
        assert abs(float(taux) - aux) <= TOL * max(1.0, abs(aux))
        np.testing.assert_array_equal(rt.idx.numpy(), idx.reshape(
            rt.idx.shape))
        np.testing.assert_array_equal(rt.keep.numpy(), keep.reshape(
            rt.keep.shape))
        dropped += int((~rt.keep).sum())
    assert dropped > 0  # capacity dropped some choices


def test_expert_split_exact():
    """tests/test_expert_split.py in the port: each expert's FFN halved
    into two sub-experts gives the unsplit result."""
    cfg1 = TR.get_smoke_config("grok-1-314b", dtype="float32",
                               capacity_factor=16.0)
    cfg2 = dataclasses.replace(cfg1, expert_split=2)
    rng = np.random.default_rng(0)
    e, d, ff = cfg1.n_experts, cfg1.d_model, cfg1.d_ff
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, np.float32) * 0.1)
    p1 = {"router": t(d, e), "w_gate": t(e, d, ff), "w_up": t(e, d, ff),
          "w_down": t(e, ff, d)}
    halves = lambda w: w.reshape(e, d, 2, ff // 2).permute(0, 2, 1, 3) \
        .reshape(2 * e, d, ff // 2)
    p2 = {"router": p1["router"], "w_gate": halves(p1["w_gate"]),
          "w_up": halves(p1["w_up"]),
          "w_down": p1["w_down"].reshape(2 * e, ff // 2, d)}
    x = torch.from_numpy(rng.standard_normal((2, 8, d), np.float32) * 0.3)
    y1, aux1 = TL.moe_block(p1, x, cfg1)
    y2, aux2 = TL.moe_block(p2, x, cfg2)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5, atol=1e-5)
    assert abs(float(aux1) - float(aux2)) <= 1e-6 * abs(float(aux1))


def test_moe_group_size_invariant():
    """tests/test_perf_opts.py's group-size invariance in the port, on the
    prefill logits (the port does not train the moe family yet): at a
    capacity no group fills, token groups of 8 give what one group does."""
    cfg0 = TR.get_smoke_config("phi3.5-moe-42b-a6.6b", dtype="float32",
                               capacity_factor=16.0)
    cfg1 = dataclasses.replace(cfg0, moe_group_size=8)
    params = TT.init_params(cfg0, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg0.vocab, (2, 32)).astype(np.int32))
    h0, aux0, _ = TT.forward_hidden(params, {"tokens": toks}, cfg0)
    h1, aux1, _ = TT.forward_hidden(params, {"tokens": toks}, cfg1)
    np.testing.assert_allclose(h0.numpy(), h1.numpy(), rtol=1e-4, atol=1e-5)
    assert float(aux0) > 0 and float(aux1) > 0


def test_length_not_a_multiple_of_the_group_is_refused():
    """s % group size != 0: the reference's reshape fails, and so does the
    port (a ValueError), without padding."""
    R = _ref()
    rcfg = R.R.get_smoke_config("phi3.5-moe-42b-a6.6b", dtype="float32",
                                moe_group_size=8)
    tcfg = TR.get_smoke_config("phi3.5-moe-42b-a6.6b", dtype="float32",
                               moe_group_size=8)
    p = _moe_weights(rcfg)
    x = np.random.default_rng(2).standard_normal((1, 12, rcfg.d_model),
                                                 np.float32)
    with pytest.raises(TypeError):
        R.L.moe_block({k: R.jnp.asarray(v) for k, v in p.items()},
                      R.jnp.asarray(x), rcfg)
    with pytest.raises(ValueError, match="multiple"):
        TL.moe_block({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), tcfg)


def test_grouped_matmul_plain_matches_reference_einsum():
    """The plain version against the reference's expert einsum
    (``ebncd,edf->ebncf``) in f32 at 1e-5, bf16 at 2e-2 of max |ref|; rows
    at or past ``counts`` are zeros; the router's f32 product over bf16
    rows; each row bit for bit the same at every row count, the one-row
    product included."""
    R = _ref()
    rng = np.random.default_rng(3)
    e, b, n, c, d, f = 4, 2, 1, 5, 64, 48
    x = rng.standard_normal((e, b, n, c, d), np.float32)
    w = rng.standard_normal((e, d, f), np.float32) * 0.1
    want = np.asarray(R.jnp.einsum("ebncd,edf->ebncf", R.jnp.asarray(x),
                                   R.jnp.asarray(w)))
    got = GM.grouped_matmul(torch.from_numpy(x.reshape(e, -1, d)),
                            torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                               atol=TOL * np.abs(want).max(), rtol=0)
    xb = R.jnp.asarray(x, R.jnp.bfloat16)
    wb = R.jnp.asarray(w, R.jnp.bfloat16)
    want_b = np.asarray(R.jnp.einsum("ebncd,edf->ebncf", xb, wb), np.float32)
    got_b = GM.grouped_matmul(
        torch.from_numpy(x.reshape(e, -1, d)).bfloat16(),
        torch.from_numpy(w).bfloat16())
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy().reshape(want.shape),
                               want_b, atol=2e-2 * np.abs(want_b).max(),
                               rtol=0)
    # an f32 product over bf16 weights reads them as they widen
    mixed = GM.grouped_matmul(torch.from_numpy(x.reshape(e, -1, d)),
                              torch.from_numpy(w).bfloat16())
    assert torch.equal(mixed, GM.grouped_matmul(
        torch.from_numpy(x.reshape(e, -1, d)),
        torch.from_numpy(w).bfloat16().float()))
    counts = torch.tensor([0, 3, 10, 7])
    cut = GM.grouped_matmul(torch.from_numpy(x.reshape(e, -1, d)),
                            torch.from_numpy(w), counts)
    full = got
    for g in range(e):
        k = min(int(counts[g]), full.shape[1])
        assert torch.equal(cut[g, :k], full[g, :k])
        assert not cut[g, k:].any()
    xt, wt = torch.from_numpy(x.reshape(e, -1, d)), torch.from_numpy(w)
    for r in (1, 2, 3, 8):
        assert torch.equal(GM.grouped_matmul(xt[:, :r].contiguous(), wt),
                           full[:, :r]), r
    with pytest.raises(ValueError):
        GM.grouped_matmul(xt, wt[:, :-1])


def test_engine_tokens_match_reference(model):
    R = _ref()
    _, rcfg, tcfg, params, tparams, _, _ = model
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, (2, 16)).astype(
        np.int32)
    want = np.asarray(R.Engine(rcfg, params, R.ServeConfig(
        max_new_tokens=8)).generate({"tokens": R.jnp.asarray(toks)}))
    got = Engine(tcfg, tparams, ServeConfig(max_new_tokens=8)).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got, want)


def _trace(vocab, n=5, seed=7):
    """(rid, prompt, max_new): prompts of 4-21 tokens; r0, r2 and r4 share
    a 16-token (two-block) prefix, so the later ones take the prefix-cache
    suffix pass."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(4, 6)))
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        out.append((f"r{i}", prompt.astype(np.int32), 5 + i % 3))
    return out


class _Margins:
    """The reference's top-2 logit margin at every token one request gets
    when served alone (its rows do not depend on the batch)."""

    def __init__(self, R, rcfg, rsp, bcfg):
        class Recording(R.BatchServer):
            def _sample_row(srv, logits, key):
                srv.margins.append(np.diff(np.sort(np.asarray(
                    logits)[0]))[-1])
                return super()._sample_row(logits, key)

        self.R, self.rcfg, self.rsp, self.bcfg = R, rcfg, rsp, bcfg
        self.cls = Recording

    def __call__(self, prompt, n_new):
        srv = self.cls(self.rcfg, self.rsp, bcfg=self.R.BatchConfig(
            **self.bcfg), engine="scan")
        srv.margins = []
        srv.run([self.R.Request("m", prompt, n_new)])
        return srv.margins


def assert_tokens_match(got, want, trace, margins, tol=ATOL):
    """Greedy tokens equal, or a divergence where the reference's own top-2
    margin at that step is below ``tol``."""
    for rid, prompt, n_new in trace:
        g, w = got[rid], want[rid]
        assert g.shape == w.shape, rid
        bad = np.flatnonzero(g != w)
        if bad.size:
            m = margins(prompt, n_new)[int(bad[0])]
            assert m < tol, (rid, int(bad[0]), m)


def test_batch_server_tokens_match_reference(model):
    """loop, scan and spec (reprune k=3, layer-skip keep 0.5), prefix cache
    on and off: every run's tokens equal each other bit for bit and the
    reference's scan tokens by the margin rule; the suffix pass ran."""
    R = _ref()
    _, rcfg, tcfg, _, _, rsp, tsp = model
    trace = _trace(rcfg.vocab)
    want = R.BatchServer(rcfg, rsp, bcfg=R.BatchConfig(**BCFG),
                         engine="scan").run(
        [R.Request(r, p, n) for r, p, n in trace]).outputs
    draft = TSP.draft_serving(tcfg, tsp, 0.9)
    runs = {}
    for prefix in (True, False):
        bcfg = BatchConfig(prefix_cache=prefix, **BCFG)
        for engine, kw in (("loop", {}), ("scan", {}),
                           ("spec", {"draft": draft,
                                     "spec": TSP.SpecConfig(k=3)}),
                           ("spec", {"spec": TSP.SpecConfig(
                               k=2, draft="layerskip", keep=0.5)})):
            srv = BatchServer(tcfg, tsp, engine=engine, device="cpu",
                              bcfg=bcfg, **kw)
            name = (engine, kw.get("spec", TSP.SpecConfig()).draft, prefix)
            runs[name] = srv.run([Request(r, p, n) for r, p, n in trace])
    base = runs[("scan", "reprune", True)]
    assert base.prefix["hits"] >= 1
    assert_tokens_match(base.outputs, want, trace,
                        _Margins(R, rcfg, rsp, BCFG))
    for name, rep in runs.items():
        for rid in base.outputs:
            np.testing.assert_array_equal(rep.outputs[rid],
                                          base.outputs[rid],
                                          err_msg=str((name, rid)))


def test_verify_equals_sequential_steps(model):
    """A T-token verify gives each position exactly what T one-token
    ``decode_step_paged`` calls give (logits and K/V), on the loop and the
    scan runtime: every token is routed alone and the router and expert
    products are row by row."""
    _, _, tcfg, _, _, _, tsp = model
    rng = np.random.default_rng(5)
    b, t, sv = 3, 4, 32
    shape = (tcfg.n_layers, b, sv, tcfg.n_kv_heads, tcfg.dh)
    vk = torch.from_numpy(rng.standard_normal(shape, np.float32))
    vv = torch.from_numpy(rng.standard_normal(shape, np.float32))
    pos = torch.tensor([3, 10, 20], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (b, t)).astype(
        np.int32))
    for sp in (tsp, TST.stack(tsp)):
        logits, kn, vn = TDP.verify_step(sp, vk, vv, pos, toks, tcfg)
        views_k, views_v = vk.clone(), vv.clone()
        rows = torch.arange(b)
        for i in range(t):
            lg, k1, v1 = TDP.decode_step_paged(sp, views_k, views_v, pos + i,
                                               toks[:, i:i + 1], tcfg)
            assert torch.equal(lg, logits[:, i]), i
            assert torch.equal(k1, kn[:, :, i]) and torch.equal(
                v1, vn[:, :, i]), i
            views_k[:, rows, (pos + i).long()] = k1
            views_v[:, rows, (pos + i).long()] = v1


def test_layerskip_masks_and_shared_stacks(model):
    """The layer-skip masks equal the reference's on the same packing (the
    float expert stacks count as fully live); the reprune draft tier shares
    the expert stacks and routers with the target; stacking shares them
    with the model params and the per-layer leaves (nothing copied)."""
    R = _ref()
    arch, rcfg, tcfg, _, tparams, rsp, tsp = model
    rimp = R.SP.sublayer_importance(R.ST.stack(rsp))
    imp = TSP.sublayer_importance(TST.stack(tsp))
    for a, b in zip(imp, rimp):
        np.testing.assert_array_equal(a, np.asarray(b))
    for keep in (0.25, 0.5, 0.75):
        assert TSP.layerskip_masks(rcfg.n_layers, keep, imp) == \
            R.SP.layerskip_masks(rcfg.n_layers, keep, rimp)
    draft = TSP.draft_serving(tcfg, tsp, 0.9)
    for p, q in zip(tsp.layers, draft.layers):
        for k in ("router", "w_gate", "w_up", "w_down"):
            assert q[k] is p[k], k
    own = TDP.compress(tcfg, tparams, target_sparsity=0.6, tile=(16, 16),
                       uniform=True)
    sx = TST.stack(own)
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert sx.dense[k].data_ptr() == tparams["layers"][k].data_ptr(), k


def test_stack_frees_per_layer_copies_and_keeps_tokens(model):
    """Per-layer float leaves that are separate tensors (an artifact's)
    are stacked once and rebound to views of the stack, so one copy stays;
    the loop runtime's tokens are bit for bit the same after it."""
    _, rcfg, tcfg, _, _, _, tsp = model
    sp = TDP.ServingParams(embed=tsp.embed, final_ln=tsp.final_ln,
                           layers=[{k: (v.clone() if torch.is_tensor(v)
                                        else v) for k, v in p.items()}
                                   for p in tsp.layers],
                           head=tsp.head, head_t=tsp.head_t)
    trace = _trace(rcfg.vocab, seed=9)
    bcfg = BatchConfig(**BCFG)
    before = BatchServer(tcfg, sp, device="cpu", bcfg=bcfg).run(
        [Request(r, p, n) for r, p, n in trace])
    sx = TST.stack(sp)
    for i, p in enumerate(sp.layers):
        for k in ("w_gate", "ln1"):
            assert p[k].data_ptr() == sx.dense[k][i].data_ptr(), (i, k)
    after = BatchServer(tcfg, sp, device="cpu", bcfg=bcfg).run(
        [Request(r, p, n) for r, p, n in trace])
    scan = BatchServer(tcfg, sp, device="cpu", bcfg=bcfg,
                       engine="scan").run(
        [Request(r, p, n) for r, p, n in trace])
    for rid in before.outputs:
        np.testing.assert_array_equal(after.outputs[rid],
                                      before.outputs[rid])
        np.testing.assert_array_equal(scan.outputs[rid],
                                      before.outputs[rid])


# (group count, rows, K, N, x type, w type): the phi3.5-moe expert and
# down shapes at a decode's rows, the router, and the odd edges (N and K
# off the tiles, one row)
GPU_SHAPES = [(16, 8, 4096, 6400, torch.bfloat16, torch.bfloat16),
              (16, 8, 6400, 4096, torch.float32, torch.bfloat16),
              (1, 20, 4096, 16, torch.float32, torch.float32),
              (3, 1, 100, 333, torch.float32, torch.float32),
              (2, 37, 250, 130, torch.bfloat16, torch.bfloat16)]


@pytest.mark.cuda
def test_grouped_matmul_kernel_matches_plain_on_gpu():
    """The kernel against its plain version on the card: f32 within 1e-5 of
    max |plain|, bf16 within 2e-2; counts zero their rows; every call
    repeated bit for bit; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n0, n = GM.LAUNCHES, 0
    for g, r, k, nn, xt, wt in GPU_SHAPES:
        x = torch.randn((g, r, k), generator=gen, device="cuda").to(xt)
        w = (torch.randn((g, k, nn), generator=gen, device="cuda")
             / k ** 0.5).to(wt)
        counts = torch.randint(0, r + 1, (g,), generator=gen,
                               device="cuda", dtype=torch.int32)
        for c in (None, counts):
            got = GM.grouped_matmul(x, w, c)
            again = GM.grouped_matmul(x, w, c)
            n += 2
            want = GM.grouped_matmul_plain(x, w, c)
            assert got.dtype == want.dtype == xt
            tol = 2e-2 if xt == torch.bfloat16 else 1e-5
            err = float((got.float() - want.float()).abs().max())
            assert err <= tol * max(1.0, float(want.float().abs().max()))
            assert torch.equal(got, again)
    assert GM.LAUNCHES == n0 + n


@pytest.mark.cuda
def test_grouped_matmul_rows_invariant_on_gpu():
    """The property the moe slice stands on: the same rows come out bit for
    bit at R = 1, 2, 8, 64 and a verify's 4 * (k + 1) = 12 rows, whatever
    the other rows hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for g, _, k, nn, xt, wt in GPU_SHAPES[:3]:
        x = torch.randn((g, 64, k), generator=gen, device="cuda").to(xt)
        w = (torch.randn((g, k, nn), generator=gen, device="cuda")
             / k ** 0.5).to(wt)
        full = GM.grouped_matmul(x, w)
        for r in (1, 2, 8, 12, 64):
            assert torch.equal(GM.grouped_matmul(x[:, :r].contiguous(), w),
                               full[:, :r]), r
            other = torch.cat([x[:, :1], torch.randn(
                (g, r, k), generator=gen, device="cuda").to(xt)], 1)
            assert torch.equal(GM.grouped_matmul(other, w)[:, 0],
                               full[:, 0]), r
