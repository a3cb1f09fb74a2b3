"""The training CLI for the moe and hybrid families, its refusal of the
encdec and vlm families, and the grouped product's gradient, which the moe
router and expert stacks train through.

The model-level cases of the moe (phi3.5-moe, grok-1), hybrid
(zamba2-1.2b), encdec (whisper-tiny) and vlm (llava-next-34b) families
against the reference (loss and every gradient leaf, the lasso, three
optimizer steps, checkpoints both ways) are cases of
``tests/test_torch_train.py``'s tests. This file runs that module's CLI
checks (``check_cli_log_lines``, ``check_cli_resume``) on the moe and
hybrid smoke configs; it is a file of its own so that a run spread over
workers file by file does not put every training case on one worker.

JAX is imported only inside the CLI cases, through
``tests/test_torch_train.py``: the GPU machine has none, and the ``cuda``
case runs there.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as GM
from repro_torch.launch import train as TLT
from repro_torch.models import layers as TL
from repro_torch.models import registry as TR
from repro_torch.train import checkpoint as TCK
from repro_torch.train import trainer as TTR

B, S = 4, 24


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

CLI_ARCHS = ("phi3.5-moe-42b-a6.6b", "zamba2-1.2b")


def _train_tests():
    """``tests/test_torch_train.py`` (it imports JAX)."""
    import test_torch_train
    return test_torch_train


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_moe_and_hybrid_cli_log_lines_match_reference(arch, tmp_path,
                                                      capsys):
    _train_tests().check_cli_log_lines(arch, tmp_path, capsys)


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_moe_and_hybrid_cli_resume_equals_a_straight_run(
        arch, tmp_path, capsys, monkeypatch):
    _train_tests().check_cli_resume(arch, tmp_path, capsys, monkeypatch)


@pytest.mark.parametrize("arch,missing", [("whisper-tiny", "frames"),
                                          ("llava-next-34b", "patch_embeds")])
def test_cli_refuses_the_families_that_need_more_than_tokens(
        arch, missing, tmp_path, monkeypatch):
    def never(*a, **k):
        raise AssertionError("a train state was built")

    monkeypatch.setattr(TLT, "init_train_state", never)
    with pytest.raises(ValueError, match=missing):
        TLT.main(["--arch", arch, "--smoke", "--steps", "6", "--cim",
                  "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# The grouped product's gradient
# ---------------------------------------------------------------------------

GM_CASES = [  # (G, R, K, N, x type, w type, counts)
    (3, 5, 7, 4, torch.float32, torch.float32, (5, 2, 0)),
    (2, 6, 9, 3, torch.float32, torch.bfloat16, (6, 1)),
    (2, 4, 8, 5, torch.bfloat16, torch.bfloat16, None),
    (2, 3, 6, 4, torch.bfloat16, torch.float32, (3, 0)),
    (4, 1, 16, 8, torch.float32, torch.float32, None),
]


def _gm_inputs(g, r, k, n, xt, wt, counts, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((g, r, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((g, k, n)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((g, r, n)).astype(np.float32))
    c = None if counts is None else torch.tensor(counts)
    return (x.to(xt).requires_grad_(), w.to(wt).requires_grad_(),
            dy.to(xt), c)


@pytest.mark.parametrize("case", GM_CASES, ids=str)
def test_grouped_backward_matches_autograd_of_the_plain_product(case):
    """The Function's dx and dw against ``torch.autograd`` through the
    plain version's own ops (``bmm`` over ``w.to(x.dtype)``, rows past
    ``counts`` zeroed by ``where``), in the operands' types; the rows of
    dx past ``counts`` are zero."""
    x, w, dy, c = _gm_inputs(*case)
    y = GM.grouped_matmul(x, w, c)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    r = x.shape[1]
    want_y = torch.bmm(x, w.to(x.dtype))
    if c is not None:
        filled = (torch.arange(r)[None, :] < c[:, None])[..., None]
        want_y = torch.where(filled, want_y, 0.0)
    wdx, wdw = torch.autograd.grad(want_y, (x, w), dy)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    tol = 1e-6 if x.dtype == torch.float32 else 1e-2
    for got, want in ((dx, wdx), (dw, wdw)):
        scale = float(want.float().abs().max()) + 1e-30
        assert float((got.float() - want.float()).abs().max()) <= tol * scale
    if c is not None:
        for gi, cnt in enumerate(c.tolist()):
            assert not dx[gi, cnt:].any()


def test_grouped_gradcheck_in_f64_with_counts():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 5, 6))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 6, 4))).requires_grad_()
    c = torch.tensor([5, 3, 0])
    assert torch.autograd.gradcheck(
        lambda a, b: GM.grouped_matmul(a, b, c), (x, w))
    assert torch.autograd.gradcheck(
        lambda a, b: GM.grouped_matmul_plain(a, b, c), (x, w))
    x1 = torch.from_numpy(rng.standard_normal((3, 1, 6))).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: GM.grouped_matmul(a, b),
                                    (x1, w))


def test_grouped_forward_is_unchanged_without_a_gradient():
    """Under ``no_grad`` (and for operands that need none) the wrapper
    records nothing and gives the same bits as with a gradient."""
    x, w, _, c = _gm_inputs(3, 5, 7, 4, torch.float32, torch.float32,
                            (5, 2, 0))
    with_grad = GM.grouped_matmul(x, w, c)
    with torch.no_grad():
        plain = GM.grouped_matmul(x, w, c)
    bare = GM.grouped_matmul(x.detach(), w.detach(), c)
    assert plain.grad_fn is None and bare.grad_fn is None
    assert torch.equal(plain, with_grad) and torch.equal(bare, with_grad)


@pytest.mark.cuda
def test_moe_train_grads_on_the_kernel_match_the_plain_path_on_gpu():
    """On the card: one step's gradients of the phi3.5-moe smoke config
    (f32, dense) with the grouped product on its kernel against the plain
    version, within 1e-4 of each leaf's max with equal routing; the
    kernel's forward launches 4 a layer and its backward none; every
    router and expert leaf reached."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = TR.get_smoke_config("phi3.5-moe-42b-a6.6b", dtype="float32",
                              remat="full")
    st = TTR.init_train_state(cfg, TTR.TrainConfig(),
                              torch.Generator(device="cuda").manual_seed(0),
                              "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    routes = []
    route = TL.moe_route

    def recording(*a):
        rt = route(*a)
        routes.append((rt.idx.clone(), rt.keep.clone()))
        return rt

    def grads():
        routes.clear()
        (_, ce), g = TTR.value_and_grad(TTR.make_loss_fn(cfg), st["params"],
                                        batch)
        return float(ce), g, list(routes)

    saved = TL.moe_route, GM.grouped_matmul
    try:
        TL.moe_route = recording
        n0 = GM.LAUNCHES
        ce, g, rk = grads()
        # router and three experts a layer, each layer run again by remat
        assert GM.LAUNCHES - n0 == 4 * cfg.n_layers * 2
        GM.grouped_matmul = GM.grouped_matmul_plain
        ce_p, g_p, rp = grads()
    finally:
        TL.moe_route, GM.grouped_matmul = saved
    assert len(rk) == len(rp) and all(
        torch.equal(a, b) for x, y in zip(rk, rp) for a, b in zip(x, y))
    assert abs(ce - ce_p) <= 1e-5 * abs(ce_p)
    for (k, a), (_, b) in zip(TCK.flatten(g), TCK.flatten(g_p)):
        scale = float(b.abs().max()) + 1e-30
        assert float((a - b).abs().max()) <= 1e-4 * scale, k
        if k.rsplit("/", 1)[-1] in ("router", "w_gate", "w_up", "w_down"):
            assert float(a.norm()) > 0, k
