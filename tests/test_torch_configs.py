"""The dense configs granite-8b, stablelm-12b and gemma3-27b in the port
against the reference, and the reference's serving traces replayed on a
dense and a moe config.

Smoke configs in float32 with the reference's own parameters and packing
(``compress(uniform=True, tile=(16, 16), target_sparsity=0.6)``), carried
across exactly by ``convert``. gemma3's smoke config has five sliding-
window layers (window 32, RoPE theta 1e4) to one global layer (theta 1e6)
and a tied head; a 7-layer variant with window 4 decodes past its window.
The bars: per-layer windows and thetas equal the reference's; logits
within ATOL = 1e-4 (the frameworks order f32 sums differently, ~1e-7 at
these widths); greedy tokens equal the reference's, a token being allowed
to differ only where the reference's own top-2 margin at that step is
below ATOL; inside the port loop = scan = spec, prefix on = off, and
verify = T one-token steps (through the tied head's row-by-row product),
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as RR
from repro.models import transformer as RT
from repro.serve import deployed as RDP
from repro.serve.batching import Request as RRequest
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro.serve.server import BatchConfig as RBatchConfig
from repro.serve.server import BatchServer as RBatchServer
from repro_torch import convert
from repro_torch.models import registry as TR
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchConfig, BatchServer, Request
from repro_torch.serve import deployed as TDP
from repro_torch.serve import spec as TSP
from repro_torch.serve import stacked as TST
from repro_torch.serve.engine import Engine, ServeConfig

DENSE = ("granite-8b", "stablelm-12b", "gemma3-27b")
ATOL = 1e-4
BCFG = dict(n_slots=3, block_size=8, n_blocks=64)


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


def _build(arch, **over):
    """(rcfg, tcfg, reference params, port params, reference packing, port
    packing) of a smoke config."""
    rcfg = RR.get_smoke_config(arch, dtype="float32", **over)
    tcfg = TR.get_smoke_config(arch, dtype="float32", **over)
    params = RR.model_fns(rcfg).init_params(rcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    rsp = RDP.compress(rcfg, params, target_sparsity=0.6, tile=(16, 16),
                       uniform=True)
    tsp = convert.serving_params_from_numpy(_export(rsp), tcfg, device="cpu")
    return rcfg, tcfg, params, tparams, rsp, tsp


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    return (request.param,) + _build(request.param)


@pytest.fixture(scope="module")
def gemma_window4():
    """gemma3 cut to 7 layers (six local, one global) with window 4."""
    return _build("gemma3-27b", n_layers=7, window=4)


class _Margins:
    """The reference's top-2 logit margin at every token of one request
    served alone (its rows do not depend on the batch)."""

    def __init__(self, rcfg, rsp, bcfg):
        class Recording(RBatchServer):
            def _sample_row(srv, logits, key):
                srv.margins.append(np.diff(np.sort(np.asarray(
                    logits)[0]))[-1])
                return super()._sample_row(logits, key)

        self.rcfg, self.rsp, self.bcfg, self.cls = rcfg, rsp, bcfg, Recording

    def __call__(self, prompt, n_new):
        srv = self.cls(self.rcfg, self.rsp, bcfg=RBatchConfig(**self.bcfg),
                       engine="scan")
        srv.margins = []
        srv.run([RRequest("m", prompt, n_new)])
        return srv.margins


def _assert_tokens_match(got, want, trace, margins):
    for rid, prompt, n_new in trace:
        g, w = got[rid], want[rid]
        assert g.shape == w.shape, rid
        bad = np.flatnonzero(g != w)
        if bad.size:
            m = margins(prompt, n_new)[int(bad[0])]
            assert m < ATOL, (rid, int(bad[0]), m)


def _trace(vocab, n=5, seed=7, lo=4, hi=6, new=5):
    """(rid, prompt, max_new): r0, r2 and r4 share a 16-token prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(lo, hi)))
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        out.append((f"r{i}", prompt.astype(np.int32), new + i % 3))
    return out


def _serve_all(tcfg, tsp, trace, bcfg):
    """Every port runtime over ``trace``: loop and scan, spec with the
    reprune and the layer-skip draft, prefix cache on and off. Returns the
    reports by (engine, draft family, prefix)."""
    draft = TSP.draft_serving(tcfg, tsp, 0.9)
    runs = {}
    for prefix in (True, False):
        b = BatchConfig(prefix_cache=prefix, **bcfg)
        for engine, kw in (("loop", {}), ("scan", {}),
                           ("spec", {"draft": draft,
                                     "spec": TSP.SpecConfig(k=3)}),
                           ("spec", {"spec": TSP.SpecConfig(
                               k=2, draft="layerskip", keep=0.5)})):
            srv = BatchServer(tcfg, tsp, engine=engine, device="cpu",
                              bcfg=b, **kw)
            name = (engine, kw.get("spec", TSP.SpecConfig()).draft, prefix)
            runs[name] = srv.run([Request(r, p, n) for r, p, n in trace])
    return runs


def _assert_all_equal(runs, base):
    for name, rep in runs.items():
        for rid in base.outputs:
            np.testing.assert_array_equal(rep.outputs[rid],
                                          base.outputs[rid],
                                          err_msg=str((name, rid)))


def _verify_equals_steps(tcfg, tsp, pos, t=4, sv=48, seed=5):
    """A T-token verify against T one-token steps, bit for bit, on both
    runtimes."""
    rng = np.random.default_rng(seed)
    b = len(pos)
    shape = (tcfg.n_layers, b, sv, tcfg.n_kv_heads, tcfg.dh)
    vk = torch.from_numpy(rng.standard_normal(shape, np.float32))
    vv = torch.from_numpy(rng.standard_normal(shape, np.float32))
    pos = torch.tensor(pos, dtype=torch.int32)
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
            assert torch.equal(k1, kn[:, :, i]), i
            views_k[:, rows, (pos + i).long()] = k1
            views_v[:, rows, (pos + i).long()] = v1


@pytest.mark.parametrize("arch", DENSE + ("phi3.5-moe-42b-a6.6b",
                                          "grok-1-314b", "zamba2-1.2b",
                                          "whisper-tiny", "llava-next-34b"))
def test_config_fields_and_layer_kinds_equal_reference(arch):
    """Each ported config equals the reference's field for field (at full
    size and smoke size), and so do the per-layer windows and thetas."""
    for get_r, get_t in ((RR.get_config, TR.get_config),
                         (RR.get_smoke_config, TR.get_smoke_config)):
        r, t = get_r(arch), get_t(arch)
        rf = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        assert rf == tf
        windows, thetas = RT._layer_kind_arrays(r)
        got_w, got_t = TT._layer_kind_arrays(t)
        assert got_w == np.asarray(windows).tolist()
        np.testing.assert_array_equal(np.asarray(got_t, np.float32),
                                      np.asarray(thetas))


def test_prefill_and_engine_match_reference(model):
    """Uncompressed prefill logits within ATOL and Engine tokens equal."""
    _, rcfg, tcfg, params, tparams, _, _ = model
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, (2, 40)).astype(
        np.int32)
    want, _ = jax.jit(RT.prefill, static_argnames=("cfg",))(
        params, {"tokens": jnp.asarray(toks)}, cfg=rcfg)
    got, _ = TT.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    want = np.asarray(REngine(rcfg, params, RServeConfig(
        max_new_tokens=8)).generate({"tokens": jnp.asarray(toks)}))
    got = Engine(tcfg, tparams, ServeConfig(max_new_tokens=8)).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got, want)


def test_batch_server_tokens_match_reference(model):
    """The compressed packing through every runtime, prefix cache on and
    off: all equal bit for bit, and equal to the reference's scan tokens
    by the margin rule."""
    _, rcfg, tcfg, _, _, rsp, tsp = model
    trace = _trace(rcfg.vocab)
    want = RBatchServer(rcfg, rsp, bcfg=RBatchConfig(**BCFG),
                        engine="scan").run(
        [RRequest(r, p, n) for r, p, n in trace]).outputs
    runs = _serve_all(tcfg, tsp, trace, BCFG)
    base = runs[("scan", "reprune", True)]
    assert base.prefix["hits"] >= 1
    _assert_tokens_match(base.outputs, want, trace,
                         _Margins(rcfg, rsp, BCFG))
    _assert_all_equal(runs, base)


def test_verify_equals_sequential_steps(model):
    arch, _, tcfg, _, _, _, tsp = model
    _verify_equals_steps(tcfg, tsp, pos=(3, 17, 40))


def test_gemma3_decodes_past_its_window(gemma_window4):
    """Window 4 over prompts of 6-9 tokens and 12 new ones: the local
    layers' keys are cut on every step. Engine and the compressed batch
    server equal the reference; verify = steps with positions past the
    window; all port runtimes equal."""
    rcfg, tcfg, params, tparams, rsp, tsp = gemma_window4
    assert tcfg.layer_kinds() == (1, 1, 1, 1, 1, 0, 1)
    toks = np.random.default_rng(6).integers(0, rcfg.vocab, (2, 6)).astype(
        np.int32)
    want = np.asarray(REngine(rcfg, params, RServeConfig(
        max_new_tokens=12)).generate({"tokens": jnp.asarray(toks)}))
    got = Engine(tcfg, tparams, ServeConfig(max_new_tokens=12)).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got, want)
    trace = _trace(rcfg.vocab, n=4, seed=8, lo=6, hi=10, new=12)
    want = RBatchServer(rcfg, rsp, bcfg=RBatchConfig(**BCFG),
                        engine="scan").run(
        [RRequest(r, p, n) for r, p, n in trace]).outputs
    runs = _serve_all(tcfg, tsp, trace, BCFG)
    base = runs[("scan", "reprune", True)]
    _assert_tokens_match(base.outputs, want, trace,
                         _Margins(rcfg, rsp, BCFG))
    _assert_all_equal(runs, base)
    _verify_equals_steps(tcfg, tsp, pos=(5, 12, 30))


# the request traces of tests/test_stacked.py and tests/test_serve_batch.py
# (generator, seed, count, longest prompt, most new tokens, batch config)
TRACES = {
    "stacked": (7, 5, 12, 7, dict(n_slots=2, block_size=4, n_blocks=24)),
    "serve_batch": (5, 7, 14, 9, dict(n_slots=3, block_size=4,
                                      n_blocks=32)),
}


@pytest.mark.parametrize("arch", ["granite-8b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("trace_name", sorted(TRACES))
def test_reference_traces_replayed(arch, trace_name):
    """The two reference test files' traces (random prompt lengths, a
    small pool that recycles blocks) through the port's loop and scan
    runtimes on a dense and a moe config: equal bit for bit, and equal to
    the reference's loop tokens by the margin rule."""
    seed, n, max_prompt, max_new, bcfg = TRACES[trace_name]
    rcfg, tcfg, _, _, rsp, tsp = _build(arch)
    rng = np.random.default_rng(seed)
    trace = [(f"r{i}", rng.integers(0, rcfg.vocab,
                                    int(rng.integers(2, max_prompt))),
              int(rng.integers(1, max_new))) for i in range(n)]
    want = RBatchServer(rcfg, rsp, bcfg=RBatchConfig(**bcfg)).run(
        [RRequest(r, p, k) for r, p, k in trace]).outputs
    reps = [BatchServer(tcfg, tsp, engine=e, device="cpu",
                        bcfg=BatchConfig(**bcfg)).run(
        [Request(r, p, k) for r, p, k in trace]) for e in ("loop", "scan")]
    assert reps[0].kv_stats["reused_blocks"] > 0
    _assert_tokens_match(reps[0].outputs, want, trace,
                         _Margins(rcfg, rsp, bcfg))
    _assert_all_equal({"scan": reps[1]}, reps[0])
