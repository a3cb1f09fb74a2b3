"""Mamba2 SSD intra-chunk block: the CUDA kernel's wrapper, launch plan and
plain version.

``csrc/ssd_intra.cu`` replaces the Pallas TPU kernel ``ssd_intra_chunk`` of
``repro/kernels/ssd_intra.py``. For every chunk c and head h, in f32:

  cum    = cumsum(a[c, h])                         (l,)
  L[i,j] = exp(cum_i - cum_j) for i >= j, else 0   (l, l)
  y[c, :, h] = ((c_c b_c^T) * L) @ x[c, :, h]      (l, P)

Layout (the reference's):
  a: (C, H, l) f32    b, c: (C, l, N)    x: (C, l, H, P)    y: (C, l, H, P)
b, c and x share one type, f32 or bf16. ``out_dtype`` is ``x.dtype`` unless
given: ``ssd_chunked`` asks for f32, so the model path rounds ``y_diag`` no
earlier than the reference does. The kernel writes f32; any other
``out_dtype`` is a cast of that, as in the plain version.

The kernel runs on bf16 tensor cores: ``c b^T`` once per chunk and row tile
for a group of heads, ``(S * L) @ x`` with S * L as a bf16 hi plane and a lo
plane (``split_hi_lo`` is the CPU twin of that split), f32 operands as three
exact bf16 planes. ``plan`` picks the head group and the grid from the
shapes and the SM count. The wrapper takes the plain version only for
tensors on the CPU (or the meta device, shapes only); for CUDA tensors it
launches the kernel or raises.
``LAUNCHES`` counts the launches, ``LAUNCHES_BY_PATH`` the same launches by
operand type and load path.

Gradients. When an operand needs a gradient and grad mode is on, the
CUDA path runs through an autograd Function whose backward is
``ssd_intra_chunk_bwd``, the kernel of ``csrc/ssd_intra_bwd.cu``: three
launches on bf16 tensor cores. The first makes S^T = B C^T of the causal
64 x 64 tiles. In the second, a cluster of two blocks owns a chunk, a
64-column tile of the l x l plane and BWD_HEADS heads; each block takes
BWD_SUB heads through dM = dy x^T, dx = M^T dy and G's sums, and the
cluster merges its heads' dS through distributed shared memory into one
partial per head group (no per-head l x l buffer reaches device memory).
The third makes dC and dB from the partials summed in order, and da from
G's sums. Every f32 operand (dy, M and dS always; x, b and c on the f32
path) goes in as three exact bf16 planes (``split3``) with the six plane
products of order <= 2^-16 kept, a bf16 one as one plane; a fixed
summation order and no atomics make each call repeat bit for bit.
``BWD_LAUNCHES`` counts its calls. The CPU path is plain torch, so
autograd differentiates the plain version itself, and
``ssd_intra_chunk_bwd_plain`` is that gradient as a function.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ..device import PLAIN_DEVICES
from . import _build

LAUNCHES = 0
BWD_LAUNCHES = 0
LAUNCHES_BY_PATH = {"bf16 aligned": 0, "bf16 masked": 0, "f32 aligned": 0,
                    "f32 masked": 0}
MAX_LEN = 1024  # l of at most 4 passes over the kernel's 256 S columns

# the kernel's tiling (csrc/ssd_intra.cu): ROWS rows per i-tile, at most
# MAX_S_COLS columns of S per pass, a ring of STAGES stages, each the larger
# of a phase-1 stage (64 rows of c and of b over 32 columns of N, rows
# padded to 40) and a phase-2 stage (two heads of 32 x rows over 64 columns
# of P, rows padded to 72), at most MAX_HEADS heads per block
ROWS, MAX_S_COLS, THREADS, STAGES, MAX_HEADS = 64, 256, 256, 4, 16
_STAGE_ELEMS = max(2 * ROWS * (32 + 8), 2 * 32 * (64 + 8))
SMS = 132  # streaming multiprocessors of an H100 SXM, unless told
MIN_BLOCKS = 2  # the launch bounds' resident blocks per SM (128 registers)
_SMEM_PER_SM, _SMEM_RESERVED = 233472, 1024  # per SM, and kept per block
# the backward kernel's tiling (csrc/ssd_intra_bwd.cu): BWD_TILE x BWD_TILE
# tiles of the l x l plane, BWD_HEADS heads a cluster (one partial dS each)
# of blocks of BWD_SUB heads
BWD_TILE, BWD_HEADS, BWD_SUB = 64, 8, 4

_LIB = None
_BWD_LIB = None
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Plan:
    heads: int       # heads per block (the last group may hold fewer)
    groups: int      # head groups, ceil(H / heads)
    row_tiles: int   # i-tiles of ROWS rows, ceil(l / ROWS)
    s_cols: int      # S columns per pass, min(row_tiles * ROWS, MAX_S_COLS)
    blocks: int      # grid: chunks x row_tiles x groups
    smem_bytes: int  # dynamic shared memory per block
    blocks_per_sm: int  # resident blocks an SM holds
    path: str        # "<bf16|f32> <aligned|masked>"
    n_chunks: int
    n_heads: int

    def block(self, idx: int) -> Tuple[int, int, int, int]:
        """(chunk, i-tile, first head, end head) of block ``idx``, as the
        kernel decodes it: the heaviest i-tile first."""
        per_tile = self.n_chunks * self.groups
        tile = self.row_tiles - 1 - idx // per_tile
        chunk, grp = divmod(idx % per_tile, self.groups)
        h0 = grp * self.heads
        return chunk, tile, h0, min(self.n_heads, h0 + self.heads)


def smem_bytes(elem: int, l: int, heads: int) -> int:
    """The kernel's dynamic shared memory: the staging ring, S (ROWS rows
    of s_cols + 8 f32) and the decay's prefix sums (each head of the
    group, l padded to ROWS)."""
    lpad = -(-l // ROWS) * ROWS
    s_cols = min(lpad, MAX_S_COLS)
    return (STAGES * _STAGE_ELEMS * elem + ROWS * (s_cols + 8) * 4
            + heads * lpad * 4)


@functools.lru_cache(maxsize=256)
def plan(n_chunks: int, n_heads: int, l: int, dtype: torch.dtype,
         aligned: bool, sms: int = SMS) -> Plan:
    """The kernel's launch plan for (C, H, l) in ``dtype`` on the load path
    ``aligned`` picks (``is_aligned``).

    The causal work of i-tile k (0-based) is k + 1 tile units per head, so
    a chunk's heads carry H * T (T + 1) / 2 of them over T i-tiles. A head
    group fits when its heaviest block (the last i-tile, T units a head)
    is at most the average load of a resident block slot (``sms`` times
    the blocks an SM holds at that group's shared memory), so that the
    blocks, dispatched heaviest first, even out over the SMs. Among the
    even divisors of H (at most MAX_HEADS) that fit, the plan takes the
    one with the most resident blocks per SM, then the largest (S is
    computed once per block and shared by its group). With no such
    divisor it ranks every even count alike, the last group masked (two
    when none fits; one head when H = 1)."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"b, c and x must be float32 or bfloat16, got {dtype}")
    elem = 2 if dtype == torch.bfloat16 else 4
    tiles = -(-l // ROWS)
    work = n_chunks * n_heads * tiles * (tiles + 1) / 2

    def per_sm(heads):
        return max(1, min(_SMEM_PER_SM // (smem_bytes(elem, l, heads)
                                           + _SMEM_RESERVED),
                          2048 // THREADS, MIN_BLOCKS))

    def fits(heads):
        return heads * tiles <= work / (sms * per_sm(heads))

    if n_heads == 1:
        heads = 1
    else:
        evens = [g for g in range(2, min(n_heads, MAX_HEADS) + 1, 2)
                 if n_heads % g == 0 and fits(g)]
        masked = [g for g in range(2, min(n_heads, MAX_HEADS) + 1, 2)
                  if fits(g)]
        rank = lambda g: (per_sm(g), g)  # resident blocks first
        heads = (max(evens, key=rank) if evens
                 else max(masked, key=rank) if masked else 2)
    groups = -(-n_heads // heads)
    return Plan(heads, groups, tiles, min(tiles * ROWS, MAX_S_COLS),
                n_chunks * tiles * groups, smem_bytes(elem, l, heads),
                per_sm(heads), f"{'bf16' if elem == 2 else 'f32'} "
                f"{'aligned' if aligned else 'masked'}", n_chunks, n_heads)


def is_aligned(b: torch.Tensor, c: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether the 16-byte path can take the operands: b, c and x 16-byte
    aligned, and rows of N and of P elements whole 16-byte chunks. a and y
    are read and written element by element."""
    elem = x.element_size()
    return (all(t.data_ptr() % 16 == 0 for t in (b, c, x))
            and (b.shape[-1] * elem) % 16 == 0
            and (x.shape[-1] * elem) % 16 == 0)


def launch_plan(a, b, c, x) -> Plan:
    n_c, n_h, l = a.shape
    return plan(n_c, n_h, l, x.dtype, is_aligned(b, c, x),
                _sm_count(x.get_device()))


@functools.lru_cache(maxsize=64)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_hi_lo(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of f32 ``S * L`` into two bf16 planes, on any
    device: ``hi = bf16(v)``, ``lo = bf16(v - hi)``, each rounded to
    nearest even; ``hi + lo`` is within 2^-17 |v| of v (two 8-bit
    significands, the second rounded), and each plane times a bf16 x is
    exact in f32."""
    v = v.float()
    hi = v.to(torch.bfloat16)
    lo = (v - hi.float()).to(torch.bfloat16)
    return hi, lo


def split3(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The kernels' split of an f32 operand into three bf16 planes, on any
    device: each plane is the remainder of the ones before, rounded to
    nearest even, in f32; p0 + p1 + p2 = v exactly for normal f32 (three
    8-bit significands), and each plane times a bf16 plane is exact in
    f32."""
    v = v.float()
    p0 = v.to(torch.bfloat16)
    r = v - p0.float()
    p1 = r.to(torch.bfloat16)
    return p0, p1, (r - p1.float()).to(torch.bfloat16)


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0
    for path in LAUNCHES_BY_PATH:
        LAUNCHES_BY_PATH[path] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ssd_intra")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_intra_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                         i, i, i, p]
        lib.ssd_intra_launch.restype = i
        lib.ssd_intra_error_string.argtypes = [i]
        lib.ssd_intra_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("ssd_intra_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_intra_bwd_launch.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.ssd_intra_bwd_launch.restype = i
        lib.ssd_intra_bwd_workspace_floats.argtypes = [i, i, i]
        lib.ssd_intra_bwd_workspace_floats.restype = ctypes.c_int64
        lib.ssd_intra_bwd_group_heads.argtypes = []
        lib.ssd_intra_bwd_group_heads.restype = i
        if lib.ssd_intra_bwd_group_heads() != BWD_HEADS:
            raise RuntimeError("csrc/ssd_intra_bwd.cu's head group is not "
                               f"BWD_HEADS = {BWD_HEADS}")
        lib.ssd_intra_bwd_error_string.argtypes = [i]
        lib.ssd_intra_bwd_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def _check(a, b, c, x) -> None:
    if a.dim() != 3 or b.dim() != 3 or c.dim() != 3 or x.dim() != 4:
        raise ValueError("expected a (C, H, l), b and c (C, l, N), x (C, l, "
                         f"H, P); got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {tuple(x.shape)}")
    n_c, n_h, l = a.shape
    if (tuple(b.shape[:2]) != (n_c, l) or b.shape != c.shape
            or tuple(x.shape[:3]) != (n_c, l, n_h)):
        raise ValueError("a, b, c and x disagree on (C, H, l): "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}, {tuple(x.shape)}")


def ssd_intra_chunk_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                          x: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: the (C, H, l, l) decay and score tensors are
    built in full, in f32. With b, c, x and the result all bf16 (the
    reference's ``ssd_lowp``) it rounds where the reference's bf16 einsum
    does instead: the decay L to bf16, and C B^T, its product with L and
    the product with x each in bf16."""
    _check(a, b, c, x)
    bf = torch.bfloat16
    lowp = (out_dtype or x.dtype) == bf and all(
        t.dtype == bf for t in (b, c, x))
    l = a.shape[-1]
    cum = a.float().cumsum(-1)
    causal = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))  # exp(-inf) = 0: no overflow above i = j
    decay = torch.exp(diff)  # (C, H, l, l)
    if lowp:
        s = torch.einsum("cin,cjn->cij", c.to(bf), b.to(bf))
        y = torch.einsum("chij,cjhp->cihp", decay.to(bf) * s[:, None],
                         x.to(bf))
        return y.to(out_dtype or x.dtype)
    s = torch.einsum("cin,cjn->cij", c.float(), b.float())
    y = torch.einsum("chij,cjhp->cihp", decay * s[:, None], x.float())
    return y.to(out_dtype or x.dtype)


class _SSDIntraChunk(torch.autograd.Function):
    """The forward and the backward on their kernels."""

    @staticmethod
    def forward(ctx, a, b, c, x, out_dtype):
        ctx.save_for_backward(a, b, c, x)
        return _launch(a, b, c, x, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_intra_chunk_bwd(*ctx.saved_tensors, dy), None)


def ssd_intra_chunk(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    x: torch.Tensor, out_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """Batched intra-chunk SSD (module docstring) on the kernel,
    differentiable through the backward kernel. With b, c, x and the
    result bf16 (the reference's ``ssd_lowp``) the plain version rounds
    where the reference does (:func:`ssd_intra_chunk_plain`); the kernel's
    bf16 route keeps its f32 products and rounds once, at the end, and is
    held to that plain version within the bf16 tolerance."""
    _check(a, b, c, x)
    if a.device.type in PLAIN_DEVICES:
        return ssd_intra_chunk_plain(a, b, c, x, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if any(t.device != a.device for t in (b, c, x)):
        raise ValueError("all operands must lie on one CUDA device")
    out_dtype = out_dtype or x.dtype
    if (a.dtype != torch.float32 or x.dtype not in _KERNEL_DTYPES
            or b.dtype != x.dtype or c.dtype != x.dtype
            or out_dtype not in _KERNEL_DTYPES):
        raise TypeError("the ssd_intra kernel takes a in float32, b, c and x "
                        "in one of float32/bfloat16 and writes float32 or "
                        f"bfloat16; got a {a.dtype}, b {b.dtype}, c "
                        f"{c.dtype}, x {x.dtype}, out {out_dtype}")
    if not all(t.is_contiguous() for t in (a, b, c, x)):
        raise ValueError("ssd_intra operands must be contiguous")
    if a.shape[-1] > MAX_LEN:
        raise ValueError(f"the ssd_intra kernel takes l <= {MAX_LEN}, got "
                         f"l={a.shape[-1]}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (a, b, c, x)):
        return _SSDIntraChunk.apply(a, b, c, x, out_dtype)
    return _launch(a, b, c, x, out_dtype)


def _launch(a, b, c, x, out_dtype: torch.dtype) -> torch.Tensor:
    n_c, n_h, l = a.shape
    n, p = b.shape[-1], x.shape[-1]
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y.to(out_dtype)
    pl = launch_plan(a, b, c, x)
    lib = _lib()
    dev = x.get_device()
    # the raw handle of the current stream (torch.cuda.current_stream()
    # builds a Stream object, several us of host time per launch)
    err = lib.ssd_intra_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), y.data_ptr(),
        n_c, n_h, l, n, p, int(x.dtype == torch.bfloat16), pl.heads,
        int(pl.path.endswith("aligned")), pl.smem_bytes, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError("ssd_intra kernel launch failed: "
                           f"{lib.ssd_intra_error_string(err).decode()}")
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PATH[pl.path] += 1
    return y.to(out_dtype)


def ssd_intra_chunk_bwd_plain(a: torch.Tensor, b: torch.Tensor,
                              c: torch.Tensor, x: torch.Tensor,
                              dy: torch.Tensor
                              ) -> Tuple[torch.Tensor, ...]:
    """(da, db, dc, dx) for the output gradient ``dy``: autograd through
    the plain version (f32 math), each gradient in its operand's type."""
    _check(a, b, c, x)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (a, b, c, x)]
        y = ssd_intra_chunk_plain(*ins, out_dtype=torch.float32)
        return torch.autograd.grad(y, ins, dy.float())


def ssd_intra_chunk_bwd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        x: torch.Tensor, dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """(da, db, dc, dx) on the backward kernel (``csrc/ssd_intra_bwd.cu``),
    each in its operand's type; the plain version only for tensors on the
    CPU. ``dy`` (C, l, H, P) in f32 or bf16."""
    _check(a, b, c, x)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if a.device.type in PLAIN_DEVICES:
        return ssd_intra_chunk_bwd_plain(a, b, c, x, dy)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if any(t.device != a.device for t in (b, c, x, dy)):
        raise ValueError("all operands must lie on one CUDA device")
    if (a.dtype != torch.float32 or x.dtype not in _KERNEL_DTYPES
            or b.dtype != x.dtype or c.dtype != x.dtype
            or dy.dtype not in _KERNEL_DTYPES):
        raise TypeError("the ssd_intra backward kernel takes a in float32, "
                        "b, c and x in one of float32/bfloat16 and dy in "
                        f"float32 or bfloat16; got a {a.dtype}, b {b.dtype},"
                        f" c {c.dtype}, x {x.dtype}, dy {dy.dtype}")
    n_c, n_h, l = a.shape
    n, p = b.shape[-1], x.shape[-1]
    if l > MAX_LEN:
        raise ValueError(f"the ssd_intra backward kernel takes l <= "
                         f"{MAX_LEN}, got l={l}")
    lib = _bwd_lib()
    bf16 = int(x.dtype == torch.bfloat16)
    a, b, c, x = (t.contiguous() for t in (a, b, c, x))
    dy = dy.float().contiguous()
    f32 = dict(dtype=torch.float32, device=a.device)
    if x.numel() == 0 or a.numel() == 0:
        return (torch.zeros(a.shape, **f32), torch.zeros(b.shape, **f32).to(
            b.dtype), torch.zeros(c.shape, **f32).to(c.dtype),
            torch.zeros(x.shape, **f32).to(x.dtype))
    # dx, the workspace (S^T of the causal tiles, a partial dS^T per head
    # group, G's row sums per column tile; 16-byte aligned), da, db, dc in
    # one allocation, the views made after the launch: a CUDA allocation
    # costs the host several us, and the host time before the first launch
    # is part of every call
    n_x = x.numel()
    o_ws = -(-n_x // 4) * 4
    o_da = o_ws + lib.ssd_intra_bwd_workspace_floats(n_c, n_h, l)
    o_db = o_da + a.numel()
    o_dc = o_db + b.numel()
    buf = torch.empty(o_dc + c.numel(), **f32)
    ptr = buf.data_ptr()
    dev = a.get_device()
    err = lib.ssd_intra_bwd_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), dy.data_ptr(),
        ptr + 4 * o_ws, ptr + 4 * o_da, ptr + 4 * o_db, ptr + 4 * o_dc, ptr,
        n_c, n_h, l, n, p, bf16, dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError("ssd_intra backward kernel launch failed: "
                           f"{lib.ssd_intra_bwd_error_string(err).decode()}")
    dx = buf[:n_x].view(x.shape)
    da = buf[o_da:o_db].view(a.shape)
    db = buf[o_db:o_dc].view(b.shape)
    dc = buf[o_dc:].view(c.shape)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return da, db.to(b.dtype), dc.to(c.dtype), dx.to(x.dtype)
