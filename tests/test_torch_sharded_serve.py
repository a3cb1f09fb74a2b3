"""Macro-sharded compressed serving in the port against the reference.

The contract, the reference's own (``tests/test_sharded_serve.py``):
sharding is a PLACEMENT decision, never a numeric one. Column-sharding
every packed projection over a ``macro`` mesh (LPT-balanced by surviving
blocks), splitting the paged-KV views by head where the macros divide the
KV heads, and scaling the block pool must give the unsharded model's
greedy tokens bit for bit. The port's mesh puts all its macros on one
device (here the CPU), one launch a macro.

Model: the smoke yi-6b in float32, ``cim_mode="qat"``, the reference's own
parameters and packing (``compress(uniform=True, tile=(16, 16),
target_sparsity=0.5)``) carried across exactly. The bars:

* the port's ``shard_weight`` on that packing equals the reference's
  integer for integer (permuted blocks, scales, row_idx, nnz, col_inv);
  the reference side comes from ONE subprocess with 8 host devices (XLA's
  device count is fixed when JAX starts), as the reference's tests do;
* ``unshard_weight`` restores the packing exactly; 1 macro and a ragged
  column count leave a projection as it is;
* a sharded projection equals the unsharded one bit for bit, each macro's
  launch planned for the whole projection's columns;
* ``BatchServer(mesh=)`` tokens at 2 and 4 macros on loop, scan and spec
  (two tiers, k = 3) with the prefix cache equal the port's 1-macro
  tokens bit for bit and the reference's unsharded tokens, a token being
  allowed to differ only where the reference's own top-2 logit margin at
  that step is below ATOL (``tests/test_torch_serve.py``'s rule).

The two ``cuda`` cases run the sharded wrappers and a sharded server on
the card and skip without one. JAX is imported inside the tests that
compare against it: the GPU machine has none.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import deploy as TD
from repro_torch.kernels import cim_bsr_matmul as TK
from repro_torch.launch import serve as TSERVE
from repro_torch.launch.shardings import (KVShards, MacroMesh,
                                          deployed_weight_specs, macro_mesh,
                                          serve_kv_view_spec)
from repro_torch.models import layers as TL
from repro_torch.models import registry as TR
from repro_torch.serve import BatchConfig, BatchServer, PagedKVCache, Request
from repro_torch.serve import deployed as TDP
from repro_torch.serve import spec as TSP
from repro_torch.serve import stacked as TST
from repro_torch.train import checkpoint as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # the margin rule's logit tolerance (tests/test_torch_serve.py)
BCFG = dict(n_slots=2, block_size=4, n_blocks=24)  # the reference test's
ARRAYS = ("blocks", "scales", "row_idx", "nnz")
KV_HEADS = (1, 2, 4, 6)  # the spec predicate's cases


def _ref():
    """The reference's modules (JAX is imported here, not at the top)."""
    import jax
    import jax.numpy as jnp
    from repro.core import deploy
    from repro.launch import shardings
    from repro.models import registry
    from repro.serve import deployed
    from repro.serve.batching import Request as RRequest
    from repro.serve.server import BatchConfig as RBatchConfig
    from repro.serve.server import BatchServer as RBatchServer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, D=deploy, SH=shardings, R=registry, DP=deployed,
        Request=RRequest, BatchConfig=RBatchConfig, BatchServer=RBatchServer)


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


@pytest.fixture(scope="module")
def models():
    R = _ref()
    rcfg = R.R.get_smoke_config("yi-6b", dtype="float32", cim_mode="qat")
    tcfg = TR.get_smoke_config("yi-6b", dtype="float32", cim_mode="qat")
    params = R.R.model_fns(rcfg).init_params(rcfg, R.jax.random.PRNGKey(0))
    rsp = R.DP.compress(rcfg, params, target_sparsity=0.5, tile=(16, 16),
                        uniform=True)
    tsp = convert.serving_params_from_numpy(_export(rsp), tcfg, device="cpu")
    tparams = convert.params_from_numpy(R.jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    return types.SimpleNamespace(R=R, rcfg=rcfg, tcfg=tcfg, rsp=rsp,
                                 tsp=tsp, tparams=tparams)


REF_SHARDS = """
import dataclasses, json, sys
import numpy as np, jax
from repro.launch.shardings import macro_mesh, serve_kv_view_spec
from repro.models import registry
from repro.serve import deployed as DP

cfg = registry.get_smoke_config("yi-6b", dtype="float32", cim_mode="qat")
params = registry.model_fns(cfg).init_params(cfg, jax.random.PRNGKey(0))
sp = DP.compress(cfg, params, target_sparsity=0.5, tile=(16, 16),
                 uniform=True)
out, specs = {}, {}
for n in (1, 2, 4, 8):
    mesh = macro_mesh(n)
    for kv in %(kv)r:
        c = dataclasses.replace(cfg, n_kv_heads=kv)
        specs[f"{n}/{kv}"] = list(serve_kv_view_spec(c, mesh))
    if n in (2, 4):
        for name, dw in DP.shard(sp, mesh).deployed().items():
            if dw.mesh is None:
                out[f"{n}/{name}/replicated"] = np.zeros(0)
                continue
            for i, p in enumerate(dw.packed):
                for k in ("blocks", "scales", "row_idx", "nnz", "col_inv"):
                    out[f"{n}/{name}/{i}/{k}"] = np.asarray(p[k])
np.savez(sys.argv[1], specs=np.asarray(json.dumps(specs)), **out)
print("OK")
""" % {"kv": KV_HEADS}


@pytest.fixture(scope="module")
def ref_shards(tmp_path_factory):
    """The reference's sharded packings at 2 and 4 macros and its KV view
    specs, from one subprocess with 8 host devices."""
    path = str(tmp_path_factory.mktemp("ref_shards") / "shards.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    env["XLA_FLAGS"] = " ".join(
        ([env["XLA_FLAGS"]] if env.get("XLA_FLAGS") else [])
        + ["--xla_force_host_platform_device_count=8"])
    r = subprocess.run([sys.executable, "-c", REF_SHARDS, path],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(str(arrays.pop("specs"))), arrays


def _cpu(n):
    return macro_mesh(n, "cpu")


# ---------------------------------------------------------------------------
# Placement: shard_weight, unshard_weight, the specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_shard_weight_matches_reference(models, ref_shards, n):
    _, ref = ref_shards
    sharded = TDP.shard(models.tsp, _cpu(n))
    plain = models.tsp.deployed()
    n_sharded = 0
    for name, dw in sharded.deployed().items():
        if f"{n}/{name}/replicated" in ref:
            assert dw is plain[name] and dw.mesh is None, name
            continue
        n_sharded += 1
        assert dw.mesh == _cpu(n)
        for i, p in enumerate(dw.packed):
            for k in ARRAYS + ("col_inv",):
                want = ref[f"{n}/{name}/{i}/{k}"]
                got = p[k].numpy()
                assert got.dtype == want.dtype, (name, k)
                np.testing.assert_array_equal(got, want, err_msg=name + k)
            g = p["blocks"].shape[0] // n
            for d, shard in enumerate(p["shards"]):  # macro d's own run
                for k, a in zip(ARRAYS, shard):
                    assert torch.equal(a, p[k][d * g:(d + 1) * g])
                    assert a.is_contiguous()
    # smoke yi-6b at 16x16: wk/wv have 2 block columns, which 4 macros
    # cannot split (the reference's ragged case), the rest shard
    assert n_sharded == (15 if n == 2 else 11)


def test_serve_kv_view_spec_matches_reference(ref_shards):
    specs, _ = ref_shards
    cfg = TR.get_smoke_config("yi-6b", dtype="float32", cim_mode="qat")
    for n in (1, 2, 4, 8):
        for kv in KV_HEADS:
            got = serve_kv_view_spec(dataclasses.replace(cfg, n_kv_heads=kv),
                                     _cpu(n))
            assert list(got) == specs[f"{n}/{kv}"], (n, kv)
    R = _ref()
    want = {k: tuple(v) for k, v in R.SH.deployed_weight_specs().items()}
    assert deployed_weight_specs() == want


def test_unshard_restores_and_ragged_stays(models):
    R = models.R
    rdep = models.rsp.deployed()
    for name, dw in models.tsp.deployed().items():
        for n in range(1, 9):
            assert TD.shardable_columns(dw, n) == R.D.shardable_columns(
                rdep[name], n), (name, n)
        assert TD.shard_weight(dw, _cpu(1)) is dw  # nothing to split
        assert TD.shard_weight(dw, _cpu(3)) is dw  # go in (2, 4, 8, 16)
        for n in (2, 4):
            s = TD.shard_weight(dw, _cpu(n))
            if not TD.shardable_columns(dw, n):
                assert s is dw
                continue
            assert TD.shard_weight(s, _cpu(n)) is s  # already placed
            u = TD.unshard_weight(s)
            assert u.mesh is None and TD.unshard_weight(u) is u
            for p, q in zip(u.packed, dw.packed):
                assert sorted(p) == ["blocks", "density", "nnz", "row_idx",
                                     "scales"]
                for k in ARRAYS:
                    assert p[k].dtype == q[k].dtype and torch.equal(p[k],
                                                                    q[k])


def test_macro_mesh_and_guards(models):
    m = macro_mesh(3, "cpu")
    assert m.axis_names == ("macro",) and m.shape == {"macro": 3}
    assert m == MacroMesh(("cpu",) * 3) and m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="n >= 1"):
        macro_mesh(0, "cpu")
    dw = next(iter(models.tsp.deployed().values()))
    with pytest.raises(ValueError, match="of the"):
        TD.shard_weight(dw, _cpu(2), assign=lambda c, n: np.zeros(len(c),
                                                                   int))
    # a mesh elsewhere than the params (macros on the meta device) raises
    meta = macro_mesh(2, "meta")
    with pytest.raises(ValueError, match="mesh's first macro"):
        TDP.shard(models.tsp, meta)
    with pytest.raises(ValueError, match="mesh's first macro"):
        BatchServer(models.tcfg, models.tsp, device="cpu", mesh=meta)
    with pytest.raises(ValueError, match="another mesh"):
        BatchServer(models.tcfg, TDP.shard(models.tsp, _cpu(2)),
                    device="cpu", mesh=_cpu(4))


# ---------------------------------------------------------------------------
# The sharded product and attention: bit for bit the unsharded ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_projection_bit_identical(models, n, monkeypatch):
    """deployed_matmul and stacked_matmul over shards equal the unsharded
    calls bit for bit at 1, 5 and 8 rows, and every macro's call is planned
    for the whole projection's columns (the S and split count of the
    unsharded call)."""
    seen = []
    run = TK._run

    def recording(entry, x, blocks, *ops, plan_go=None):
        seen.append((entry, plan_go, TK.launch_plan(x, blocks, plan_go)))
        return run(entry, x, blocks, *ops, plan_go=plan_go)

    monkeypatch.setattr(TK, "_run", recording)
    sp, mesh = models.tsp, _cpu(n)
    sps = TDP.shard(sp, mesh)
    sx, sxs = TST.stack(sp), TST.stack(sps)
    gen = np.random.default_rng(n)
    for name, dw in sps.deployed().items():
        if dw.mesh is None:
            continue
        base = sp.deployed()[name]
        go = base.packed[0]["blocks"].shape[0]
        for rows in (1, 5, 8):
            x = torch.from_numpy(gen.standard_normal((rows, dw.d_in))
                                 .astype(np.float32))
            seen.clear()
            got = TD.deployed_matmul(x, dw, a_bits=8)
            assert torch.equal(got, TD.deployed_matmul(x, base, a_bits=8))
            whole = TK.launch_plan(x, base.packed[0]["blocks"][None])
            sharded = [s for s in seen if s[0] == "bsr_matmul_sharded"]
            assert len(sharded) == n
            assert all(g == go and pl == whole for _, g, pl in sharded)
    for proj, sw in sxs.packed.items():
        assert len(sw.shards) == (n if sw.mesh == mesh else 0)
        # the kernel takes contiguous operands only
        assert all(a.is_contiguous() for s in sw.shards for a in s)
        for li in range(models.tcfg.n_layers):
            layer = torch.tensor([li], dtype=torch.int32)
            x = torch.from_numpy(gen.standard_normal((6, sw.d_in))
                                 .astype(np.float32))
            want = TD.stacked_matmul(x, sx.packed[proj], layer, a_bits=8)
            assert torch.equal(TD.stacked_matmul(x, sw, layer, a_bits=8),
                               want)
            assert torch.equal(TD.stacked_matmul(x, sw, li, a_bits=8), want)
            one = sw.layer(li)  # a standalone layer keeps its placement
            assert one.mesh == sw.mesh
            assert torch.equal(TD.deployed_matmul(x, one, a_bits=8), want)
    # why the whole projection's columns: at full-width yi-6b decode a
    # shard's own go would cut w_gate and w_down into other splits
    for kb, go in ((32, 86), (86, 32)):
        whole = TK.plan(4, kb, go, 128, torch.float32, True, True)
        assert TK.plan(4, kb, go // 2, 128, torch.float32, True,
                       True).slots != whole.slots


@pytest.mark.parametrize("n,window", [(2, 0), (4, 0), (2, 5)])
def test_attention_by_macro_bit_identical(n, window):
    """One attention call a macro over its KV heads and q heads equals one
    call over all heads, bit for bit, padding heads included."""
    gen = torch.Generator().manual_seed(n)
    b, t, kv, group, dh, sv = 3, 4, 4, 2, 16, 24
    q = torch.randn((b, t, kv * group + 2, dh), generator=gen)  # 2 pad
    q[:, :, kv * group:] = 0.0
    k, v = (torch.randn((b, sv, kv, dh), generator=gen) for _ in range(2))
    kn, vn = (torch.randn((b, t, kv, dh), generator=gen) for _ in range(2))
    pos = torch.tensor([3, 9, 17], dtype=torch.int32)
    want = TL.ops.decode_attention(q, k, v, pos, window, kv * group, kn, vn)
    split = lambda a: KVShards(a[:, :, d * (kv // n):(d + 1) * (kv // n)]
                               .contiguous() for d in range(n))
    got = TL._attention_by_macro(q, split(k), split(v), pos, window,
                                 kv * group, kn, vn)
    assert torch.equal(got, want)


def test_paged_kv_views_split_by_head(models):
    """A KV-sharded pool gathers each macro's heads, the slices of the
    unsharded gather; an assignment writes through to every part."""
    cfg = dataclasses.replace(models.tcfg, n_kv_heads=4)
    pools = {}
    for mesh in (None, _cpu(2), _cpu(4), _cpu(3)):
        kv = PagedKVCache(cfg, 2, 8, 4, device="cpu", mesh=mesh)
        for pool in (kv.pool_k, kv.pool_v):
            pool.copy_(torch.arange(pool.numel(), dtype=pool.dtype)
                       .reshape(pool.shape))
        kv.ensure(0, 9)
        kv.ensure(1, 3)
        pools[mesh] = kv
        assert kv.stats()["kv_heads_sharded"] == (mesh is not None
                                                  and mesh.size in (2, 4))
    want_k, _ = pools[None].gather(4)
    for n in (2, 4):
        vk, _ = pools[_cpu(n)].gather(4)
        assert isinstance(vk, KVShards) and vk.shape == want_k.shape
        assert all(p.is_contiguous() for p in vk.parts)
        assert torch.equal(torch.cat(vk.parts, dim=3), want_k)
        new = torch.randn((cfg.n_layers, 2) + tuple(want_k.shape[3:]))
        rows, at = torch.arange(2), torch.tensor([5, 1])
        vk[:, rows, at] = new
        assert torch.equal(torch.cat(vk[:, rows, at].parts, dim=-2), new)
    assert torch.equal(pools[_cpu(3)].gather(4)[0], want_k)  # replicated


# ---------------------------------------------------------------------------
# Serving over the mesh
# ---------------------------------------------------------------------------


def _trace():
    """The reference test's trace (seed 7), then two requests sharing an
    8-token (two-block) prefix with its first, so the prefix cache runs its
    suffix pass."""
    rng = np.random.default_rng(7)
    reqs = [(f"r{i}", rng.integers(0, 256, int(rng.integers(2, 12))),
             int(rng.integers(1, 7))) for i in range(5)]
    shared = rng.integers(0, 256, 8)
    reqs += [(f"p{i}", np.concatenate([shared, rng.integers(0, 256, 2 + i)]),
              5) for i in range(2)]
    return [(r, np.asarray(p, np.int32), m) for r, p, m in reqs]


def _port_trace():
    return [Request(r, p, m) for r, p, m in _trace()]


@pytest.fixture(scope="module")
def served(models):
    """The reference's unsharded scan tokens, the port's draft tier and
    its 1-macro tokens per engine."""
    R = models.R
    want = R.BatchServer(models.rcfg, models.rsp,
                         bcfg=R.BatchConfig(**BCFG), engine="scan").run(
        [R.Request(r, p, m) for r, p, m in _trace()]).outputs
    draft = TSP.draft_serving(models.tcfg, models.tsp, 0.8)
    one = {e: _serve(models, e, models.tsp, draft, None)
           for e in ("loop", "scan", "spec")}
    return want, draft, one


def _serve(models, engine, sp, draft, mesh):
    kw = ({"spec": TSP.SpecConfig(k=3, draft_sparsity=0.8), "draft": draft}
          if engine == "spec" else {})
    return BatchServer(models.tcfg, sp, bcfg=BatchConfig(**BCFG),
                       engine=engine, device="cpu", mesh=mesh, **kw).run(
        _port_trace())


def _ref_margin(models, seq) -> float:
    """The reference's top-2 logit margin after consuming ``seq``."""
    R = models.R
    logits, _, _ = R.DP.prefill_last(models.rsp, R.jnp.asarray(seq)[None],
                                     R.jnp.asarray(len(seq), R.jnp.int32),
                                     models.rcfg)
    top = np.sort(np.asarray(logits)[0])[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_server_tokens(models, served, n):
    """Loop, scan and spec at n macros, prefix cache on: tokens equal the
    1-macro run's bit for bit and the reference's; the pool scales only
    where the KV heads (2) shard, as the reference's test asserts."""
    want, draft, one = served
    mesh = _cpu(n)
    sps, dps = TDP.shard(models.tsp, mesh), TDP.shard(draft, mesh)
    heads_shard = models.tcfg.n_kv_heads_eff % n == 0
    for engine in ("loop", "scan", "spec"):
        rep = _serve(models, engine, sps, dps, mesh)
        assert rep.kv_stats["n_devices"] == n
        assert rep.kv_stats["kv_heads_sharded"] == heads_shard
        assert rep.kv_stats["n_blocks"] == 24 * (n if heads_shard else 1)
        assert rep.prefix["hits"] >= 1
        for rid, toks in one[engine].outputs.items():
            np.testing.assert_array_equal(rep.outputs[rid], toks,
                                          err_msg=f"{engine} {rid}")
        if engine == "spec":  # the same rounds, proposals and acceptances
            for k in ("n_rounds", "round_k", "proposed", "accepted"):
                assert rep.spec[k] == one["spec"].spec[k], k
    margins = []
    for rid, prompt, _ in _trace():
        got, exp = one["scan"].outputs[rid], want[rid]
        bad = np.flatnonzero(got != exp)
        if bad.size:  # only a near-tie in the reference may flip a token
            step = int(bad[0])
            seq = np.concatenate([prompt, exp[:step]]).astype(np.int32)
            margins.append((rid, step, _ref_margin(models, seq)))
    assert all(m < ATOL for _, _, m in margins), margins


def test_sharded_static_admission_exact(models):
    """The static (whole-batch) policy over the same sharded kernels, on
    the reference test's own packing (every block, seed-3 trace)."""
    sp = TDP.compress(models.tcfg, models.tparams, target_sparsity=0.0,
                      tile=(16, 16), uniform=True)
    rng = np.random.default_rng(3)
    trace = [(f"r{i}", rng.integers(0, 256, int(rng.integers(2, 10))),
              int(rng.integers(1, 6))) for i in range(4)]
    reps = [BatchServer(models.tcfg, s, bcfg=BatchConfig(**BCFG),
                        continuous=False, device="cpu", mesh=m).run(
        [Request(*r) for r in trace])
        for s, m in ((sp, None), (TDP.shard(sp, _cpu(2)), _cpu(2)))]
    for rid, toks in reps[0].outputs.items():
        np.testing.assert_array_equal(reps[1].outputs[rid], toks)


def test_layerskip_masks_ignore_placement(models):
    """The layer-skip draft's sublayer ranking reads block supports in
    logical column order, so sharding does not change the draft."""
    want = TSP.sublayer_importance(TST.stack(models.tsp))
    for n in (2, 4):
        got = TSP.sublayer_importance(TST.stack(TDP.shard(models.tsp,
                                                          _cpu(n))))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Serialization keeps no placement; the CLI's --mesh
# ---------------------------------------------------------------------------


def test_placement_never_serialized(models, tmp_path):
    """save_pytree refuses meshed packings and stacks; save_artifact stores
    the logical packing, which boots equal to the unsharded one and serves
    the same tokens; a draft is never re-pruned from a sharded packing."""
    mesh = _cpu(2)
    sps = TDP.shard(models.tsp, mesh)
    dw = sps.layers[0]["wq"]
    with pytest.raises(ValueError, match="unshard_weight"):
        TC.save_pytree(str(tmp_path / "a"), {"w": dw})
    with pytest.raises(ValueError, match="placement-free stacks"):
        TC.save_pytree(str(tmp_path / "b"), TD.stack_deployed([dw]))
    with pytest.raises(ValueError, match="placement-free packing"):
        TSP.draft_serving(models.tcfg, sps, 0.8)
    TDP.save_artifact(str(tmp_path / "art"), sps, models.tcfg)
    booted, _ = TDP.load_artifact(str(tmp_path / "art"), device="cpu")
    plain = models.tsp.deployed()
    for name, got in booted.deployed().items():
        assert got.mesh is None
        for p, q in zip(got.packed, plain[name].packed):
            for k in ARRAYS:
                assert torch.equal(p[k], q[k]), (name, k)
    a = BatchServer(models.tcfg, booted, bcfg=BatchConfig(**BCFG),
                    device="cpu").run(_port_trace())
    b = BatchServer(models.tcfg, sps, bcfg=BatchConfig(**BCFG),
                    device="cpu", mesh=mesh).run(_port_trace())
    for rid, toks in a.outputs.items():
        np.testing.assert_array_equal(b.outputs[rid], toks)


def test_cli_mesh_flag(tmp_path, capsys):
    assert TSERVE._parse_mesh("") is None
    assert TSERVE._parse_mesh("macro=1", "cpu").shape == {"macro": 1}
    for bad in ("model=2", "macro=x", "macro"):
        with pytest.raises(SystemExit, match="macro=N"):
            TSERVE._parse_mesh(bad, "cpu")
    art = str(tmp_path / "art")
    argv = ["--arch", "yi-6b", "--smoke", "--compressed", "--tile", "16x16",
            "--device", "cpu", "--requests", "4", "--prompt-len", "10",
            "--new-tokens", "6"]
    runs = {}
    for label, extra in (("plain", []), ("macro=2", ["--mesh", "macro=2"]),
                         ("saved", ["--artifact", art]),
                         ("booted macro=4", ["--artifact", art, "--runtime",
                                             "scan", "--mesh", "macro=4"])):
        runs[label] = TSERVE.main(argv + extra)
        out = capsys.readouterr().out
        if "macro" in label:
            n = label[-1]
            assert f"macro mesh: {{'macro': {n}}} - " in out
            assert "column-sharded (rest replicated)" in out
            assert runs[label].kv_stats["n_devices"] == int(n)
    assert "artifact: loaded" in out
    for label, rep in runs.items():
        for rid, toks in runs["plain"].outputs.items():
            np.testing.assert_array_equal(rep.outputs[rid], toks,
                                          err_msg=f"{label} {rid}")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_sharded_bsr_kernel_on_gpu():
    """The sharded wrappers on the card: un-permuted, bit for bit the
    unsharded kernel, within 1e-5 of the plain version; one launch a macro
    a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core.cim_layer import CIMConfig
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d_in, d_out, rows in ((1024, 2048, 4), (2048, 1024, 96)):
        w = torch.randn((2, d_in, d_out), generator=gen, device="cuda")
        dw = TD.deploy_weight(w * 0.05, CIMConfig(), bk=128, bn=128,
                              target_sparsity=0.6)
        x = torch.randn((rows, d_in), generator=gen, device="cuda")
        base = TD.stack_deployed([dw])
        for n in (2, 4):
            mesh = macro_mesh(n)
            sw = TD.stack_deployed([TD.shard_weight(dw, mesh)])
            layer = torch.ones(1, dtype=torch.int32, device="cuda")
            before = TK.LAUNCHES_BY_ENTRY["bsr_matmul_stacked_sharded"]
            got = TD.stacked_matmul(x, sw, layer, a_bits=8)
            assert TK.LAUNCHES_BY_ENTRY[
                "bsr_matmul_stacked_sharded"] == before + n
            assert torch.equal(got, TD.stacked_matmul(x, base, layer,
                                                      a_bits=8))
            xq = TL.ops.fake_quant(x, 8, signed=True)
            plain = TK.bsr_matmul_stacked_sharded_plain(xq, sw.shards, 1)
            y = TK.bsr_matmul_stacked_sharded(xq, sw.shards, layer)
            err = float((y - plain).abs().max())
            assert err <= 1e-5 * max(1.0, float(plain.abs().max()))


@pytest.mark.cuda
def test_sharded_server_on_gpu():
    """Smoke yi-6b with 4 KV heads on the card: scan tokens at 2 and 4
    macros equal 1 macro's; decode attention runs once a macro where the
    heads shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import decode_attention as DA
    cfg = dataclasses.replace(
        TR.get_smoke_config("yi-6b", dtype="float32", cim_mode="qat"),
        n_kv_heads=4)
    params = TR.model_fns(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    sp = TDP.compress(cfg, params, target_sparsity=0.5, tile=(16, 16),
                      uniform=True)
    reps = {}
    for n in (1, 2, 4):
        mesh = macro_mesh(n)
        srv = BatchServer(cfg, TDP.shard(sp, mesh), bcfg=BatchConfig(**BCFG),
                          engine="scan", mesh=mesh)
        before = DA.LAUNCHES
        reps[n] = srv.run(_port_trace())
        paged = reps[n].n_decode_steps + reps[n].prefix["hits"]
        assert DA.LAUNCHES - before == n * cfg.n_layers * paged
    for n in (2, 4):
        for rid, toks in reps[1].outputs.items():
            np.testing.assert_array_equal(reps[n].outputs[rid], toks)
