"""The port's training slice against the reference's (``repro.data``,
``repro.train``, ``models.transformer.train_loss``, ``launch.train``).

Models: the yi-6b and mamba2-780m smoke configs in float32 (2 layers,
d_model 64, vocab 256). Each case starts both sides from one state that
the reference's ``init_train_state`` made, carried across with
``convert.train_state_from_numpy``; batches come from the reference's
``TokenPipeline``.

Tolerances, each relative to the largest magnitude of the reference's
value (per leaf for gradients and parameters):

* dense (``cim_mode="dense"``): every op is plain f32 on both sides and
  only the order of the sums differs: loss 1e-5, gradients 1e-4.
* QAT (eq. 5 on activations, eqs. 6 and 8 on weights): the same, except
  that an activation whose f32 value the two frameworks round an ulp apart
  can land on the other side of a half-level, and one flipped eq. 5 level
  moves every gradient upstream of it by about a level's weight (2^-7 of
  the signal at 8 bits): loss 1e-4, gradients 2e-2.
* optimizer steps: AdamW divides by sqrt(v) + 1e-8, so a gradient
  component near 0 whose last digits differ moves its parameter by up to
  a share of the learning rate: parameters within 2 * lr absolute after
  three steps, the loss, lr and grad norm of each step within 1e-5.

The pipelines, the checkpoints and the CLI's resume are exact.
"""
import dataclasses
import json
import os
import re
import signal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import ImagePipeline as RImage  # noqa: E402
from repro.data import TokenPipeline as RToken  # noqa: E402
from repro.launch import train as RLT  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.train import checkpoint as RCK  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import trainer as RTR  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data import ImagePipeline, TokenPipeline  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

QAT = dict(cim_mode="qat", cim_alpha=16, cim_n=16)
LOSS_CASES = {
    "dense": ({}, False),
    "w8a8": (dict(QAT, w_bits=8, a_bits=8), False),
    "w8a8-lasso": (dict(QAT, w_bits=8, a_bits=8, lambda_g=1e-3), False),
    "w4a4-lasso-mask": (dict(QAT, w_bits=4, a_bits=4, lambda_g=1e-3), True),
    "w8a8-padded-vocab-mask": (dict(QAT, w_bits=8, a_bits=8, vocab=250,
                                    vocab_pad_multiple=64), True),
}


def _configs(arch, **over):
    over = dict(over, dtype="float32")
    return RR.get_smoke_config(arch, **over), TR.get_smoke_config(arch,
                                                                  **over)


def _states(rcfg, tcfg, rtcfg=None):
    """The reference's initial train state and the port's copy of it."""
    rtcfg = rtcfg or RTR.TrainConfig()
    st = RTR.init_train_state(rcfg, rtcfg, jax.random.PRNGKey(0))
    return st, train_state_from_numpy(jax.tree.map(np.asarray, st), tcfg,
                                      "cpu")


def _batch(vocab, batch=4, seq=24, seed=1, mask=False):
    out = RToken(vocab=vocab, batch=batch, seq_len=seq, seed=seed).next_batch()
    if mask:
        out["loss_mask"] = (np.random.default_rng(seed).random((batch, seq))
                            > 0.3).astype(np.int32)
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = (got.detach().double().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


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


@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-780m"])
def test_train_loss_and_grads_match_reference(arch, case):
    over, mask = LOSS_CASES[case]
    rcfg, tcfg = _configs(arch, **over)
    assert (tcfg.vocab_eff != tcfg.vocab) == ("padded" in case)
    st, ts = _states(rcfg, tcfg)
    batch = _batch(rcfg.vocab, mask=mask)
    (rtot, rce), rg = jax.jit(jax.value_and_grad(RTR.make_loss_fn(rcfg),
                                                 has_aux=True))(
        st["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    (ttot, tce), tg = TTR.value_and_grad(
        TTR.make_loss_fn(tcfg), ts["params"],
        {k: torch.as_tensor(v) for k, v in batch.items()})
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


def test_train_loss_raises_for_other_families():
    from repro_torch.models import transformer as TT
    rcfg, tcfg = _configs("yi-6b")
    _, ts = _states(rcfg, tcfg)
    batch = {"tokens": torch.as_tensor(_batch(tcfg.vocab)["tokens"])}
    with pytest.raises(NotImplementedError, match="moe"):
        TT.train_loss(ts["params"], batch,
                      dataclasses.replace(tcfg, family="moe"))


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


@pytest.mark.parametrize("kind,schedule,clip,accum,wd", OPT_CASES)
def test_three_train_steps_match_reference(kind, schedule, clip, accum, wd):
    rcfg, tcfg = _configs("yi-6b")
    ocfg = dict(kind=kind, lr=3e-3, warmup_steps=2, total_steps=6,
                schedule=schedule, step_decay_every=2, clip_norm=clip,
                weight_decay=wd)
    rt = RTR.TrainConfig(opt=RO.OptConfig(**ocfg), grad_accum=accum)
    tt = TTR.TrainConfig(opt=TO.OptConfig(**ocfg), grad_accum=accum)
    st, ts = _states(rcfg, tcfg, rt)
    rstep = jax.jit(RTR.make_train_step(rcfg, rt))
    tstep = TTR.make_train_step(tcfg, tt)
    for i in range(3):
        batch = _batch(rcfg.vocab, seed=10 + i)
        st, rm = rstep(st, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, {k: torch.as_tensor(v) for k, v in batch.items()})
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


def test_checkpoints_restore_across_packages(tmp_path):
    rcfg, tcfg = _configs("mamba2-780m")
    st, ts = _states(rcfg, tcfg)
    st = dict(st, step=jnp.int32(7))
    rng = np.random.default_rng(0)
    ts["step"] = 7
    for k in ts["opt"]["m"]["layers"]:  # moments that are not all zero
        v = rng.standard_normal(tuple(ts["opt"]["m"]["layers"][k].shape))
        ts["opt"]["m"]["layers"][k] = torch.as_tensor(v.astype(np.float32))
    # reference -> port
    RCK.save(str(tmp_path / "ref"), 7, st, extra={"pipe": {"step": 7,
                                                           "seed": 0}})
    _, template = _states(rcfg, tcfg)
    got, manifest = TCK.restore(str(tmp_path / "ref"), template)
    _assert_state_equal(st, got)
    assert manifest["step"] == 7 and manifest["extra"]["pipe"]["step"] == 7
    assert all(p.requires_grad for p in TO.leaves(got["params"]))
    # port -> reference
    TCK.save(str(tmp_path / "port"), 7, ts, extra={"arch": "mamba2-780m"})
    back, manifest = RCK.restore(str(tmp_path / "port"), st)
    _assert_state_equal(back, ts)
    assert manifest == {"step": 7, "extra": {"arch": "mamba2-780m"},
                        "n_arrays": len(TCK.flatten(ts))}
    assert back["step"].dtype == jnp.int32
    # the same files: key for key, dtype for dtype
    a = np.load(tmp_path / "ref" / "step_00000007" / "arrays.npz")
    b = np.load(tmp_path / "port" / "step_00000007" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(a[k].dtype == b[k].dtype for k in a.files)


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


def _argv(ckpt, steps=6, *extra):
    return ["--arch", "mamba2-780m", "--smoke", "--steps", str(steps),
            "--batch", "2", "--seq", "24", "--log-every", "2",
            "--ckpt-every", "3", "--cim", "--ckpt-dir", str(ckpt), *extra]


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln]


def test_cli_log_lines_match_reference(tmp_path, capsys):
    RLT.main(_argv(tmp_path / "ref"))
    ref = _lines(capsys)
    run = TLT.main(_argv(tmp_path / "port") + ["--device", "cpu"])
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
    with open(tmp_path / "port" / "step_00000006" / "manifest.json") as f:
        assert json.load(f)["extra"] == {"pipe": {"step": 6, "seed": 0},
                                         "arch": "mamba2-780m"}


def test_cli_resume_equals_a_straight_run(tmp_path, capsys, monkeypatch):
    straight = TLT.main(_argv(tmp_path / "a") + ["--device", "cpu"])
    # a run stopped by SIGTERM after step 2 checkpoints and exits cleanly
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
        TLT.main(_argv(tmp_path / "b") + ["--device", "cpu"])
    assert stop.value.code == 0
    assert "SIGTERM received: checkpointed and exiting cleanly" in \
        _lines(capsys)
    assert TCK.latest_step(str(tmp_path / "b")) == 2
    monkeypatch.setattr(TLT, "make_train_step", make)
    resumed = TLT.main(_argv(tmp_path / "b", 6, "--resume", "--device",
                             "cpu"))
    assert "resumed from step 2" in _lines(capsys)
    assert resumed.start_step == 2
    assert resumed.losses == straight.losses[2:]
    for a, b in zip(TO.leaves(straight.state["params"]),
                    TO.leaves(resumed.state["params"])):
        assert torch.equal(a, b)
    for a, b in zip(TO.leaves(straight.state["opt"]),
                    TO.leaves(resumed.state["opt"])):
        assert torch.equal(a, b)
    assert resumed.state["step"] == straight.state["step"] == 6


def test_cli_refuses_a_missing_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="GPU"):
        TLT.main(_argv(tmp_path, 1))
