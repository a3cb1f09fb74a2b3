#!/usr/bin/env python3
"""Where the SSD backward's main launch spends its time, per phase.

    python3 tools/profile_ssd_bwd.py [--src csrc/ssd_intra_bwd.cu]

Needs a GPU and nvcc (sm_90a). Copies ``src/repro_torch/csrc/
ssd_intra_bwd.cu`` with ``clock64`` stamps inserted at the main kernel's
phase boundaries (found by the comments that open them), builds the copy,
runs the backward once at mamba2-780m's training shape (C, H, l, N, P) =
(4, 48, 256, 128, 64) in f32, and prints, for the blocks of each column
tile, the mean cycles per warpgroup of each phase, summed over the block's
row tiles and heads:

  q-gap    between two heads (the next dx tile's copy issue)
  land     waiting for x and dy, and their conversion to bf16 planes
  dM       the dM^T wgmma products
  elem     L, M, G's sums and dS^T per element
  dx       M^T's planes, the dx wgmma products and the dx tile's round trip
  rowp     G's row sums of the head written
  exchange the dS^T exchange of the row tile before (cluster barriers)
  row-set  cum and the S^T tile of the row tile
  last-ex  the last row tile's exchange

The stamps add time of their own: compare the phases with each other, not
the total with an unstamped run. Prints the card's name and power limit
first.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["q-gap", "land", "dM", "elem", "dx", "rowp", "exchange", "row-set",
         "pre-ex", "last-ex"]
# (anchor text, where, stamp index); the stamp adds the cycles since the
# previous stamp to its phase
ANCHORS = [
    ("    for (int q = 0; q < nq; ++q) {\n", "after", 0),
    ("        uint32_t af[kT / 16][PI][4];\n#pragma unroll\n"
     "        for (int kk = 0; kk < kT / 16; ++kk)\n"
     "          frag_a<PI>(af[kk], xs,", "before", 1),
    ("      // per element: L, M = S L (into dm)", "before", 2),
    ("      // M^T as A fragments", "before", 3),
    ("      // G's row sums of this head over the tile's columns", "before", 4),
    ("      if (pipe) {\n        if (more) fetch_dx", "before", 5),
    ("    const int i0 = it * kT;\n", "after", 6),
    ("    __syncthreads();  // S^T and cum complete\n", "after", 7),
    ("    // ---- the group's dS tile", "before", 8),
    ("  // G's column sums of the block's heads over every row tile", "before",
     9),
]


def stamped(src: str) -> str:
    s = open(src).read()
    for text, where, k in ANCHORS:
        if text not in s:
            sys.exit(f"profile_ssd_bwd: anchor not found in {src}: {text!r}")
        stamp = f"PSTAMP({k});\n"
        s = s.replace(text, text + stamp if where == "after"
                      else stamp + text, 1)
    head = "  const int l = prm.l, H = prm.H, P = prm.P;\n"
    s = s.replace(head, head + (
        "  unsigned long long pacc[10] = {}, plast = clock64();\n"
        "#define PSTAMP(k) if (wtid == 0) { const unsigned long long n_ = "
        "clock64(); pacc[k] += n_ - plast; plast = n_; }\n"), 1)
    tail = ("  // buffer holds them until the finish kernel\n"
            "  __syncthreads();\n")
    s = s.replace(tail, tail + (
        "  if (wtid == 0) {\n"
        "    for (int k = 0; k < 10; ++k)\n"
        "      g_prof[(blockIdx.x * 2 + wg) * 16 + k] = pacc[k];\n"
        "    g_prof[(blockIdx.x * 2 + wg) * 16 + 10] = jt;\n"
        "  }\n"), 1)
    s = s.replace("namespace {\n", "__device__ unsigned long long "
                  "g_prof[1 << 16];\nnamespace {\n", 1)
    s = s.replace('extern "C" {\n', 'extern "C" {\n'
                  "int prof_read(void* out) { return (int)cudaMemcpyFromSymbol("
                  "out, g_prof, sizeof(g_prof)); }\n", 1)
    return s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        ROOT, "src/repro_torch/csrc/ssd_intra_bwd.cu"))
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_ssd_bwd: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    os.makedirs(args.out, exist_ok=True)
    cu = os.path.join(args.out, "ssd_intra_bwd_stamped.cu")
    so = os.path.join(args.out, "libssd_intra_bwd_stamped.so")
    with open(cu, "w") as f:
        f.write(stamped(args.src))
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra_bwd_launch.argtypes = [p] * 10 + [i] * 7 + [p]
    lib.ssd_intra_bwd_workspace_floats.argtypes = [i, i, i]
    lib.ssd_intra_bwd_workspace_floats.restype = ctypes.c_int64
    lib.ssd_intra_bwd_group_heads.restype = i
    C, H, l, N, P = 4, 48, 256, 128, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = -torch.nn.functional.softplus(
        torch.randn((C, H, l), generator=gen, device="cuda"))
    b, c = (torch.randn((C, l, N), generator=gen, device="cuda") * 0.3
            for _ in range(2))
    x = torch.randn((C, l, H, P), generator=gen, device="cuda") * 0.3
    dy = torch.randn((C, l, H, P), generator=gen, device="cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    ws = torch.empty(lib.ssd_intra_bwd_workspace_floats(C, H, l), **f32)
    outs = [torch.empty(t.shape, **f32) for t in (a, b, c, x)]

    def run():
        err = lib.ssd_intra_bwd_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(),
            dy.data_ptr(), ws.data_ptr(), *[o.data_ptr() for o in outs],
            C, H, l, N, P, 0, 0, None)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    prof = np.zeros(1 << 16, dtype=np.uint64)
    if lib.prof_read(prof.ctypes.data):
        raise RuntimeError("prof_read failed")
    tiles, groups = -(-l // 64), -(-H // lib.ssd_intra_bwd_group_heads())
    blocks = C * tiles * groups * 2  # clusters of two blocks
    rec = prof[:blocks * 2 * 16].reshape(blocks, 2, 16).astype(np.float64)
    print(f"(C, H, l, N, P) = {(C, H, l, N, P)} f32; mean cycles per "
          "warpgroup (first, second) of each phase:")
    for jt in range(tiles):
        m = rec[rec[:, 0, 10] == jt][:, :, :10].mean(0)
        cells = ", ".join(f"{n} {int(m[0, k])}/{int(m[1, k])}"
                          for k, n in enumerate(NAMES) if n != "pre-ex")
        print(f"column tile {jt} ({tiles - jt} row tiles): {cells}; total "
              f"{int(m[0].sum())}/{int(m[1].sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
