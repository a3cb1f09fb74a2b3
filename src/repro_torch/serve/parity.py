"""Where two runs of the compressed serving path part: the same packed
model on two devices (the kernels on the card, their plain versions on the
CPU) gives logits that differ, and this module says why.

Every compressed projection quantizes its activations by eq. 5 before the
block-sparse product. Two runs whose elementwise ops differ by an ulp put
an activation on the other side of a rounding edge now and then: one eq. 5
level moves by one, and every later layer carries the change. So the
attribution is a count, per projection, of the eq. 5 levels that differ,
with the first projection (in call order) where one does.

  recs = []
  with record_eq5(sp, recs):
      logits = prefill_and_step(sp, tokens, true_len, cfg)
  level_flips(recs_card, recs_cpu)
  greedy_margins(logits_card, logits_cpu, tol)

The loop runtime's projections are recorded (``ServingParams`` with
``DeployedWeight`` leaves), named as ``ServingParams.deployed`` names them.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from ..core import deploy as D
from ..kernels import ops
from . import deployed as DP

Record = Tuple[str, torch.Tensor]  # (projection, int32 eq. 5 levels)


def _levels(y: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """The integer levels of eq. 5's output (exact: a level over a power of
    two), on the CPU."""
    step = 2.0 ** (bits - 1) if signed else 2.0 ** bits
    return torch.round(y.detach().float() * step).to(torch.int32).cpu()


@contextlib.contextmanager
def record_eq5(sp: DP.ServingParams, out: List[Record]):
    """Inside the block, each eq. 5 quantization of a compressed
    projection's activations (``ops.fake_quant`` called from
    ``deploy.deployed_matmul``) appends ``(name, levels)`` to ``out``. The
    values served are unchanged."""
    names = {id(dw): name for name, dw in sp.deployed().items()}
    pending: List[str] = []
    matmul, quant = D.deployed_matmul, ops.fake_quant

    def deployed_matmul(x, dw, layer=0, a_bits=0):
        pending.append(names.get(id(dw), "?"))
        try:
            return matmul(x, dw, layer, a_bits)
        finally:
            pending.pop()

    def fake_quant(x, bits, signed=False, out_dtype=None):
        y = quant(x, bits, signed, out_dtype)
        if pending:
            out.append((pending[-1], _levels(y, bits, signed)))
        return y

    D.deployed_matmul, ops.fake_quant = deployed_matmul, fake_quant
    try:
        yield out
    finally:
        D.deployed_matmul, ops.fake_quant = matmul, quant


def _layer_of(name: str) -> Optional[int]:
    """The block index of ``blk{i}_...``; None for the head."""
    return int(name[3:name.index("_")]) if name.startswith("blk") else None


def level_flips(a: List[Record], b: List[Record]) -> dict:
    """Two recordings of the same forwards, compared call by call: per
    projection the eq. 5 levels compared, those one level apart and those
    further apart, and the first projection in call order (with its block
    index, None for the head) where any level differs."""
    if [n for n, _ in a] != [n for n, _ in b]:
        raise ValueError("the recordings did not make the same calls")
    per: Dict[str, Dict[str, int]] = {}
    first = None
    for (name, la), (_, lb) in zip(a, b):
        if la.shape != lb.shape:
            raise ValueError(f"{name}: shapes {tuple(la.shape)} and "
                             f"{tuple(lb.shape)} differ")
        d = (la.long() - lb.long()).abs()
        e = per.setdefault(name, {"levels": 0, "off_by_one": 0, "more": 0})
        e["levels"] += d.numel()
        e["off_by_one"] += int((d == 1).sum())
        e["more"] += int((d > 1).sum())
        if first is None and bool((d > 0).any()):
            first = name
    return {"per_projection": per,
            "off_by_one": sum(e["off_by_one"] for e in per.values()),
            "more": sum(e["more"] for e in per.values()),
            "first": first,
            "first_layer": None if first is None else _layer_of(first)}


def greedy_margins(ref: torch.Tensor, other: torch.Tensor,
                   tol: float) -> dict:
    """Greedy tokens of two runs' logits (rows of (R, V)) under the parity
    bar's margin rule: a row whose argmax differs is a fault when ``ref``'s
    own top-2 margin there exceeds ``tol``. Returns the rows that agree,
    those that differ with ``ref``'s margin at each, and the faults."""
    ref, other = ref.float().cpu(), other.float().cpu()
    top = ref.topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    same = ref.argmax(-1) == other.argmax(-1)
    differ = [(int(r), float(margin[r]))
              for r in (~same).nonzero().flatten()]
    return {"equal": int(same.sum()), "rows": int(ref.shape[0]),
            "differ": differ,
            "faults": [(r, m) for r, m in differ if m > tol],
            "min_margin": float(margin.min())}


def prefill_and_step(sp, tokens: torch.Tensor, true_len: int, cfg,
                     next_token: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """One prefill of ``tokens`` (1, S), logits at ``true_len - 1``, and one
    decode step at position ``true_len`` over a paged view of S + 16
    positions. The step's input is ``next_token`` ((1, 1) int32), or the
    prefill's greedy token. Returns the (2, V) logits."""
    logits, k, v = DP.prefill_last(sp, tokens, true_len, cfg)
    pad = (0, 0, 0, 0, 0, 16)  # the view is 16 positions longer
    vk, vv = (torch.nn.functional.pad(t, pad) for t in (k, v))
    nxt = (logits.argmax(-1, keepdim=True).to(torch.int32)
           if next_token is None else next_token.to(logits.device))
    pos = torch.tensor([true_len], dtype=torch.int32, device=logits.device)
    step, _, _ = DP.decode_step_paged(sp, vk, vv, pos, nxt, cfg)
    return torch.cat([logits, step])
