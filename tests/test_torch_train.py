"""The port's training slice against the reference's (``repro.data``,
``repro.train``, ``models.transformer.train_loss``,
``models.encdec.train_loss``, ``launch.train``).

Models: the smoke configs in float32 of yi-6b and mamba2-780m (2 layers,
d_model 64, vocab 256), and of the families that train beside them:
phi3.5-moe, grok-1 (with ``expert_split=2``, token groups of 8 and a
capacity factor of 0.5, so that every group drops choices), zamba2-1.2b
(two super-layers share the attention block, one tail block),
whisper-tiny (32 stub frames) and llava-next-34b (8 stub patches). Each
case starts both sides from one state that the reference's
``init_train_state`` made, carried across with
``convert.train_state_from_numpy``; tokens come from the reference's
``TokenPipeline``, frames and patches from a numpy seed.

Tolerances, each relative to the largest magnitude of the reference's
value (per leaf for gradients and parameters):

* dense (``cim_mode="dense"``): every op is plain f32 on both sides and
  only the order of the sums differs: loss 1e-5, gradients 1e-4.
* QAT (eq. 5 on activations, eqs. 6 and 8 on weights): the same, except
  that an activation whose f32 value the two frameworks round an ulp apart
  can land on the other side of a half-level, and one flipped eq. 5 level
  moves every gradient upstream of it by about a level's weight (2^-7 of
  the signal at 8 bits): loss 1e-4, gradients 2e-2. Whisper's QAT cases
  compute the port's LayerNorm, forward and backward, by the reference's
  (``test_torch_encdec.py``'s substitution, made differentiable here): the
  frameworks sum its 64-wide rows in other orders, and eq. 5 turns an ulp
  into a level.
* optimizer steps: AdamW divides by sqrt(v) + 1e-8, so a gradient
  component near 0 whose last digits differ moves its parameter by up to
  a share of the learning rate: parameters within 2 * lr absolute after
  three steps, the loss, lr and grad norm of each step within 1e-5.

The pipelines, the checkpoints and the CLI's resume are exact. The CLI
cases of the moe and hybrid families run the helpers ``check_cli_*`` of
this module from ``test_torch_train_families.py``.
"""
import io
import json
import os
import re
import signal
import struct
import zipfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import ImagePipeline as RImage  # noqa: E402
from repro.data import TokenPipeline as RToken  # noqa: E402
from repro.launch import train as RLT  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.train import checkpoint as RCK  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import trainer as RTR  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data import ImagePipeline, TokenPipeline  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

FAMILY_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b", "zamba2-1.2b",
                "whisper-tiny", "llava-next-34b")
# grok-1: sub-experts, and groups of 8 tokens at capacity 2 a group
# (max(k, int(0.5 * 8 * 2 / 4))): 16 choices, at most 8 kept
ARCH_OVER = {"grok-1-314b": dict(expert_split=2, capacity_factor=0.5,
                                 moe_group_size=8)}
QAT = dict(cim_mode="qat", cim_alpha=16, cim_n=16)
LOSS_CASES = {
    "dense": ({}, False),
    "w8a8": (dict(QAT, w_bits=8, a_bits=8), False),
    "w8a8-lasso": (dict(QAT, w_bits=8, a_bits=8, lambda_g=1e-3), False),
    "w4a4-lasso-mask": (dict(QAT, w_bits=4, a_bits=4, lambda_g=1e-3), True),
    "w8a8-padded-vocab-mask": (dict(QAT, w_bits=8, a_bits=8, vocab=250,
                                    vocab_pad_multiple=64), True),
    "w8a8-lasso-remat": (dict(QAT, w_bits=8, a_bits=8, lambda_g=1e-3,
                              remat="full"), False),
}
LOSS_PARAMS = [
    pytest.param(arch, case, id=f"{arch}-{case}")
    for arch, cases in (("yi-6b", list(LOSS_CASES)[:5]),
                        ("mamba2-780m", list(LOSS_CASES)[:5]),
                        *((a, ("dense", "w8a8-lasso", "w8a8-lasso-remat"))
                          for a in FAMILY_ARCHS))
    for case in cases]


def _configs(arch, **over):
    over = dict(ARCH_OVER.get(arch, {}), **over, dtype="float32")
    return RR.get_smoke_config(arch, **over), TR.get_smoke_config(arch,
                                                                  **over)


def _states(rcfg, tcfg, rtcfg=None):
    """The reference's initial train state and the port's copy of it."""
    rtcfg = rtcfg or RTR.TrainConfig()
    st = RTR.init_train_state(rcfg, rtcfg, jax.random.PRNGKey(0))
    return st, train_state_from_numpy(jax.tree.map(np.asarray, st), tcfg,
                                      "cpu")


def _batch(cfg, batch=4, seq=24, seed=1, mask=False):
    """Numpy batch: tokens, and the stub frames or patches the family
    reads."""
    out = RToken(vocab=cfg.vocab, batch=batch, seq_len=seq,
                 seed=seed).next_batch()
    rng = np.random.default_rng(seed)
    if mask:
        out["loss_mask"] = (rng.random((batch, seq)) > 0.3).astype(np.int32)
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal((batch, cfg.enc_seq,
                                              cfg.d_model))
                         * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = (got.detach().double().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


class _ReferenceLayerNorm(torch.autograd.Function):
    """The reference's ``layernorm`` forward and, through ``jax.vjp``,
    backward, on the port's tensors."""

    @staticmethod
    def forward(ctx, x, g, b):
        y, ctx.vjp = jax.vjp(RL.layernorm, *(
            jnp.asarray(t.detach().numpy()) for t in (x, g, b)))
        return torch.from_numpy(np.array(y))

    @staticmethod
    def backward(ctx, dy):
        grads = ctx.vjp(jnp.asarray(dy.contiguous().numpy()))
        return tuple(torch.from_numpy(np.array(g)) for g in grads)


@pytest.fixture
def shared_layernorm(monkeypatch):
    monkeypatch.setattr(TL, "layernorm",
                        lambda x, g, b: _ReferenceLayerNorm.apply(x, g, b))


# ---------------------------------------------------------------------------
# Data pipelines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["token", "image"])
def test_pipelines_bit_equal_across_steps_and_restore(kind):
    if kind == "token":
        make = lambda cls: cls(vocab=300, batch=3, seq_len=17, seed=5)
        ref, port = make(RToken), make(TokenPipeline)
    else:
        make = lambda cls: cls(batch=4, hw=8, seed=3)
        ref, port = make(RImage), make(ImagePipeline)
    for _ in range(5):
        a, b = ref.next_batch(), port.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert ref.state() == port.state()
    state = port.state()
    want = port.next_batch()
    fresh = make(TokenPipeline if kind == "token" else ImagePipeline)
    fresh.restore(state)
    got = fresh.next_batch()
    for k in want:
        assert np.array_equal(want[k], got[k])
    if kind == "token":
        with pytest.raises(ValueError, match="seed"):
            make(TokenPipeline).restore({"step": 1, "seed": 99})


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,case", LOSS_PARAMS)
def test_train_loss_and_grads_match_reference(arch, case, request):
    over, mask = LOSS_CASES[case]
    if arch == "whisper-tiny" and over:
        request.getfixturevalue("shared_layernorm")
    rcfg, tcfg = _configs(arch, **over)
    assert (tcfg.vocab_eff != tcfg.vocab) == ("padded" in case)
    st, ts = _states(rcfg, tcfg)
    rb, tb = _both(_batch(rcfg, mask=mask))
    (rtot, rce), rg = jax.jit(jax.value_and_grad(RTR.make_loss_fn(rcfg),
                                                 has_aux=True))(
        st["params"], rb)
    (ttot, tce), tg = TTR.value_and_grad(TTR.make_loss_fn(tcfg),
                                         ts["params"], tb)
    qat = bool(over)
    tol_loss, tol_grad = (1e-4, 2e-2) if qat else (1e-5, 1e-4)
    assert _rel(rtot, ttot) <= tol_loss and _rel(rce, tce) <= tol_loss
    if over.get("lambda_g"):
        assert float(rtot) > float(rce) and float(ttot) > float(tce)
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert len(flat) == len(TO.leaves(tg))
    for path, g in flat:
        got = _leaf(tg, path)
        assert got.shape == g.shape and got.dtype == torch.float32, path
        assert _rel(g, got) <= tol_grad, (path, _rel(g, got))
    # the leaves a grouped product without a gradient would zero, and
    # those of the hybrid's shared block and the vlm's projector, reached
    for name in ("router", "w_gate", "w_up", "w_down", "mm_proj",
                 "shared_attn", "attn_gate"):
        for path, g in flat:
            if name in [str(p.key) for p in path]:
                assert float(_leaf(tg, path).norm()) > 0, path


def test_moe_cases_route_as_described():
    """grok-1's cases drop choices in every group; the moe loss carries
    0.01 of the aux loss, as the reference's."""
    from repro_torch.models import transformer as TT
    rcfg, tcfg = _configs("grok-1-314b")
    gs = min(tcfg.moe_group_size, 24)
    cap = max(tcfg.top_k, int(tcfg.capacity_factor * gs * tcfg.top_k
                              / tcfg.n_experts))
    assert gs * tcfg.top_k > tcfg.n_experts * cap  # drops by pigeonhole
    _, ts = _states(rcfg, tcfg)
    tb = _both(_batch(tcfg))[1]
    hidden, aux, _ = TT.forward_hidden(ts["params"], tb, tcfg)
    assert float(aux.detach()) > 0
    lf = TL.logits_out(ts["params"]["head"], hidden, tcfg.cim)
    ce = TL.cross_entropy(lf[:, :-1], tb["tokens"][:, 1:])
    torch.testing.assert_close(TT.train_loss(ts["params"], tb, tcfg),
                               ce + 0.01 * aux, rtol=0, atol=0)


def test_lm_regularization_matches_reference():
    rcfg, tcfg = _configs("mamba2-780m", **dict(QAT, lambda_g=1e-3))
    st, ts = _states(rcfg, tcfg)
    want = RTR.lm_regularization(st["params"], rcfg.cim)
    got = TTR.lm_regularization(ts["params"], tcfg.cim)
    assert _rel(want, got) <= 1e-6
    # a zero tile keeps a finite gradient (the 1e-24 inside the norm)
    w = torch.zeros((32, 32), requires_grad=True)
    from repro_torch.core.sparsity import group_lasso_2d
    group_lasso_2d(w, 16, 16).backward()
    assert torch.isfinite(w.grad).all()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_lm_regularization_keeps_the_reference_weight_keys(arch):
    """The lasso over each family's tree (expert stacks, the hybrid's body,
    encdec's self/cross/mlp, the projector) equals the reference's, over
    the same leaves of the WEIGHT_KEYS filter."""
    rcfg, tcfg = _configs(arch, **dict(QAT, w_bits=8, a_bits=8,
                                       lambda_g=1e-3))
    st, ts = _states(rcfg, tcfg)
    want = RTR.lm_regularization(st["params"], rcfg.cim)
    got = TTR.lm_regularization(ts["params"], tcfg.cim)
    assert _rel(want, got) <= 1e-6
    flat = jax.tree_util.tree_flatten_with_path(st["params"])[0]
    ref_keys = {"/".join(str(p.key) for p in path) for path, leaf in flat
                if RTR._leaf_name(path) in RTR.WEIGHT_KEYS}
    port_keys = {k for k, _ in TCK.flatten(ts["params"])
                 if k.rsplit("/", 1)[-1] in TTR.WEIGHT_KEYS}
    assert ref_keys == port_keys and TTR.WEIGHT_KEYS == RTR.WEIGHT_KEYS
    need = {"phi3.5-moe-42b-a6.6b": "layers/w_gate",
            "grok-1-314b": "layers/w_down",
            "zamba2-1.2b": "layers_body/in_proj",
            "whisper-tiny": "dec_layers/cross/wq",
            "llava-next-34b": "mm_proj"}[arch]
    assert need in port_keys


# ---------------------------------------------------------------------------
# Optimizer steps through make_train_step
# ---------------------------------------------------------------------------

OPT_CASES = [
    ("adamw", "cosine", 1.0, 1, 0.0),
    ("adamw", "step", 0.0, 2, 0.01),
    ("adamw", "const", 1.0, 2, 0.0),
    ("sgdm", "cosine", 0.0, 1, 0.0),
    ("sgdm", "step", 1.0, 2, 0.01),
    ("sgdm", "const", 0.0, 1, 0.0),
]


OPT_PARAMS = [
    pytest.param("yi-6b", *case, id="-".join(map(str, case)))
    for case in OPT_CASES] + [
    pytest.param(arch, kind, "cosine", 1.0, accum, 0.0,
                 id=f"{arch}-{kind}-{accum}")
    for arch in FAMILY_ARCHS for kind, accum in (("adamw", 1), ("sgdm", 2))]


@pytest.mark.parametrize("arch,kind,schedule,clip,accum,wd", OPT_PARAMS)
def test_three_train_steps_match_reference(arch, kind, schedule, clip, accum,
                                           wd):
    """Three steps of ``make_train_step``; ``grad_accum=2`` runs the loss,
    the moe aux loss included, on each microbatch."""
    rcfg, tcfg = _configs(arch)
    ocfg = dict(kind=kind, lr=3e-3, warmup_steps=2, total_steps=6,
                schedule=schedule, step_decay_every=2, clip_norm=clip,
                weight_decay=wd)
    rt = RTR.TrainConfig(opt=RO.OptConfig(**ocfg), grad_accum=accum)
    tt = TTR.TrainConfig(opt=TO.OptConfig(**ocfg), grad_accum=accum)
    st, ts = _states(rcfg, tcfg, rt)
    rstep = jax.jit(RTR.make_train_step(rcfg, rt))
    tstep = TTR.make_train_step(tcfg, tt)
    for i in range(3):
        rb, tb = _both(_batch(rcfg, seed=10 + i))
        st, rm = rstep(st, rb)
        ts, tm = tstep(ts, tb)
        for key in ("loss", "lr", "grad_norm"):
            assert _rel(rm[key], tm[key]) <= 1e-5, (i, key)
    assert ts["step"] == int(st["step"]) == 3
    for path, p in jax.tree_util.tree_flatten_with_path(st["params"])[0]:
        got = _leaf(ts["params"], path).detach().numpy()
        assert np.abs(np.asarray(p) - got).max() <= 2 * ocfg["lr"], path
    for mom in st["opt"]:
        for path, m in jax.tree_util.tree_flatten_with_path(
                st["opt"][mom])[0]:
            got = _leaf(ts["opt"][mom], path)
            assert _rel(m, got) <= 1e-3, (mom, path)


def test_schedule_lr_matches_reference_bit_for_bit():
    for schedule in ("cosine", "step", "const"):
        kw = dict(lr=3e-3, warmup_steps=3, total_steps=11,
                  schedule=schedule, step_decay_every=4)
        for step in range(14):
            want = RO.schedule_lr(RO.OptConfig(**kw), jnp.int32(step))
            got = TO.schedule_lr(TO.OptConfig(**kw), step)
            assert np.float32(want) == got.numpy(), (schedule, step)


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------


def _assert_state_equal(ref_state, port_state):
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]:
        got = _leaf(port_state, path)
        if isinstance(got, int):
            assert got == int(leaf), path
        else:
            assert np.array_equal(np.asarray(leaf), got.detach().numpy()), path


def _checkpoints_both_ways(arch, tmp_path):
    """A train state at step 7 with moments that are not zero, reference ->
    port and port -> reference, key for key and bit for bit, in files with
    the same keys and dtypes."""
    rcfg, tcfg = _configs(arch)
    st, _ = _states(rcfg, tcfg)
    rng = np.random.default_rng(0)
    moments = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), st["opt"])
    st = dict(st, opt=moments, step=jnp.int32(7))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, st), tcfg, "cpu")
    paths = {"/".join(str(p.key) for p in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(st)[0]}
    assert ts["step"] == 7 and paths == {k for k, _ in TCK.flatten(ts)}
    # reference -> port
    RCK.save(str(tmp_path / "ref"), 7, st, extra={"pipe": {"step": 7,
                                                           "seed": 0}})
    _, template = _states(rcfg, tcfg)
    got, manifest = TCK.restore(str(tmp_path / "ref"), template)
    _assert_state_equal(st, got)
    assert manifest["step"] == 7 and manifest["extra"]["pipe"]["step"] == 7
    assert all(p.requires_grad for p in TO.leaves(got["params"]))
    # port -> reference
    TCK.save(str(tmp_path / "port"), 7, ts, extra={"arch": arch})
    back, manifest = RCK.restore(str(tmp_path / "port"), st)
    _assert_state_equal(back, ts)
    assert manifest == {"step": 7, "extra": {"arch": arch},
                        "n_arrays": len(TCK.flatten(ts))}
    assert back["step"].dtype == jnp.int32
    # the same files: key for key, dtype for dtype
    a = np.load(tmp_path / "ref" / "step_00000007" / "arrays.npz")
    b = np.load(tmp_path / "port" / "step_00000007" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(a[k].dtype == b[k].dtype for k in a.files)


def test_checkpoints_restore_across_packages(tmp_path):
    _checkpoints_both_ways("mamba2-780m", tmp_path)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_checkpoints_of_each_family_restore_across_packages(arch, tmp_path):
    _checkpoints_both_ways(arch, tmp_path)


def test_restore_reads_stored_and_compressed_members_alike(tmp_path):
    """``restore`` reads ``np.savez``'s stored members (straight from the
    file) and compressed ones (``np.savez_compressed``, through numpy's
    reader) alike: the same values in C or Fortran order, f32, bf16,
    int32, empty."""
    tree = {"a": torch.randn(3, 5), "b": {"c": torch.randn(7).bfloat16(),
                                          "d": torch.arange(4).int()},
            "e": torch.randn(0, 3), "step": 4}
    d = str(tmp_path)
    TCK.save(d, 4, tree)
    arrays = {k: (np.asarray(v, np.int32) if isinstance(v, int)
                  else TCK._to_numpy(v)[0]) for k, v in TCK.flatten(tree)}
    path = tmp_path / "step_00000004" / "arrays.npz"
    for write in (None, np.savez_compressed,
                  lambda p, **a: np.savez(p, **{
                      k: np.asfortranarray(v) if v.ndim else v
                      for k, v in a.items()})):
        if write:
            write(path, **arrays)
        got, _ = TCK.restore(d, tree)
        for k, want in TCK.flatten(tree):
            have = dict(TCK.flatten(got))[k]
            if isinstance(want, int):
                assert have == want
            else:
                assert have.dtype == want.dtype and torch.equal(have, want)


def test_save_writes_the_file_np_savez_writes(tmp_path):
    """``save`` writes ``np.savez``'s format: a zip that passes
    ``testzip``, with the same members, dtypes, shapes and values as
    ``np.savez`` of the same arrays (f32, bf16, int8, int32, a scalar,
    empty)."""
    tree = {"a": torch.randn(33, 7), "b": {"c": torch.randn(5).bfloat16(),
                                           "d": torch.arange(-4, 4).to(
                                               torch.int8)},
            "e": torch.randn(0, 3), "step": 9}
    TCK.save(str(tmp_path), 9, tree)
    path = tmp_path / "step_00000009" / "arrays.npz"
    arrays = {k: (np.asarray(v, np.int32) if isinstance(v, int)
                  else TCK._to_numpy(v)[0]) for k, v in TCK.flatten(tree)}
    np.savez(tmp_path / "ref.npz", **arrays)
    with zipfile.ZipFile(path) as zf:
        assert zf.testzip() is None
    got, want = np.load(path), np.load(tmp_path / "ref.npz")
    assert got.files == want.files == list(arrays)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[
            k].shape and got[k].tobytes() == want[k].tobytes(), k


def _corrupt(npz, fault):
    """Flip the last data byte of the npz's first member, or write that
    member again with a .npy header that claims one element more than it
    holds."""
    with zipfile.ZipFile(npz) as zf:
        first = zf.infolist()[0]
        members = {i.filename: zf.read(i) for i in zf.infolist()}
    if fault == "flipped byte":
        raw = bytearray(open(npz, "rb").read())
        at = first.header_offset
        name_len, extra_len = struct.unpack("<HH", raw[at + 26:at + 30])
        raw[at + 30 + name_len + extra_len + first.file_size - 1] ^= 1
        open(npz, "wb").write(bytes(raw))
        return
    arr = np.load(io.BytesIO(members[first.filename]))
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(head, {
        "descr": np.lib.format.dtype_to_descr(arr.dtype),
        "fortran_order": False, "shape": (arr.size + 1,)})
    members[first.filename] = head.getvalue() + arr.tobytes()
    with zipfile.ZipFile(npz, "w") as zf:
        for name, data in members.items():
            zf.writestr(name, data)


@pytest.mark.parametrize("reader", ["restore", "load_pytree"])
@pytest.mark.parametrize("fault,match", [("flipped byte", "CRC"),
                                         ("short member", "truncated")])
def test_readers_refuse_a_member_its_zip_record_disagrees_with(
        reader, fault, match, tmp_path):
    """A stored member whose bytes do not match the zip's CRC-32, or whose
    .npy header claims more than the zip's size holds, raises
    ``BadZipFile`` in both readers, as ``np.load`` would."""
    tree = {"a": torch.randn(3, 5), "step": 4}
    d = str(tmp_path)
    if reader == "restore":
        TCK.save(d, 4, tree)
        load = lambda: TCK.restore(d, tree)
    else:
        TCK.save_pytree(d, {"a": tree["a"]}, step=4)
        load = lambda: TCK.load_pytree(d, device="cpu")
    load()
    _corrupt(tmp_path / "step_00000004" / "arrays.npz", fault)
    with pytest.raises(zipfile.BadZipFile, match=match):
        load()


def test_save_is_atomic_and_gc_keeps_the_latest(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "step": 0}
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        TCK.save(d, step, dict(tree, step=step), keep=2)
        assert not any(n.startswith(".tmp") for n in os.listdir(d))
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    assert TCK.latest_step(d) == 5
    got, _ = TCK.restore(d, tree, step=4)
    assert got["step"] == 4 and torch.equal(got["w"], tree["w"])
    RCK.save(d, 9, {"w": jnp.ones((2,))}, keep=3)  # the reference's gc
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005",
                                     "step_00000009"]
    TCK._gc(d, 1)
    assert os.listdir(d) == ["step_00000009"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

LINE = re.compile(r"step (\d+) loss=\d+\.\d{4} lr=\d\.\d\de[-+]\d\d "
                  r"gnorm=\d+\.\d\d \(\d+\.\ds\)$")


def _argv(ckpt, steps=6, *extra, arch="mamba2-780m"):
    return ["--arch", arch, "--smoke", "--steps", str(steps), "--batch",
            "2", "--seq", "24", "--log-every", "2", "--ckpt-every", "3",
            "--cim", "--ckpt-dir", str(ckpt), *extra]


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln]


def check_cli_log_lines(arch, tmp_path, capsys):
    """The port's CLI logs the reference CLI's steps and summary and keeps
    the same checkpoints."""
    RLT.main(_argv(tmp_path / "ref", arch=arch))
    ref = _lines(capsys)
    run = TLT.main(_argv(tmp_path / "port", arch=arch) + ["--device", "cpu"])
    port = _lines(capsys)
    assert len(ref) == len(port) == 5
    for a, b in zip(ref[:-1], port[:-1]):
        assert LINE.match(a) and LINE.match(b), (a, b)
        assert a.split()[:2] == b.split()[:2]  # the same steps logged
    assert re.match(r"done: 6 steps in \d+\.\ds; final loss \d+\.\d{4}$",
                    port[-1])
    assert ref[-1].split(";")[0].split(" in ")[0] == \
        port[-1].split(";")[0].split(" in ")[0]
    assert sorted(os.listdir(tmp_path / "ref")) == sorted(
        os.listdir(tmp_path / "port")) == ["step_00000003", "step_00000006"]
    assert len(run.losses) == 6 and run.start_step == 0
    assert all(np.isfinite(run.losses))
    with open(tmp_path / "port" / "step_00000006" / "manifest.json") as f:
        assert json.load(f)["extra"] == {"pipe": {"step": 6, "seed": 0},
                                         "arch": arch}


def check_cli_resume(arch, tmp_path, capsys, monkeypatch):
    """A run stopped by SIGTERM after step 2 checkpoints and exits cleanly;
    ``--resume`` then gives the straight run's losses, parameters and
    moments bit for bit."""
    straight = TLT.main(_argv(tmp_path / "a", arch=arch) + ["--device", "cpu"])
    make = TLT.make_train_step

    def stopping(cfg, tcfg):
        step = make(cfg, tcfg)

        def run(state, batch):
            out = step(state, batch)
            if state["step"] == 2:
                signal.raise_signal(signal.SIGTERM)
            return out
        return run

    monkeypatch.setattr(TLT, "make_train_step", stopping)
    with pytest.raises(SystemExit) as stop:
        TLT.main(_argv(tmp_path / "b", arch=arch) + ["--device", "cpu"])
    assert stop.value.code == 0
    assert "SIGTERM received: checkpointed and exiting cleanly" in \
        _lines(capsys)
    assert TCK.latest_step(str(tmp_path / "b")) == 2
    monkeypatch.setattr(TLT, "make_train_step", make)
    resumed = TLT.main(_argv(tmp_path / "b", 6, "--resume", "--device",
                             "cpu", arch=arch))
    assert "resumed from step 2" in _lines(capsys)
    assert resumed.start_step == 2
    assert resumed.losses == straight.losses[2:]
    for part in ("params", "opt"):
        for a, b in zip(TO.leaves(straight.state[part]),
                        TO.leaves(resumed.state[part])):
            assert torch.equal(a, b)
    assert resumed.state["step"] == straight.state["step"] == 6


def test_cli_log_lines_match_reference(tmp_path, capsys):
    check_cli_log_lines("mamba2-780m", tmp_path, capsys)


def test_cli_resume_equals_a_straight_run(tmp_path, capsys, monkeypatch):
    check_cli_resume("mamba2-780m", tmp_path, capsys, monkeypatch)


def test_cli_refuses_a_missing_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="GPU"):
        TLT.main(_argv(tmp_path, 1))
