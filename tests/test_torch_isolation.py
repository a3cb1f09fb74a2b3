"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``."""
import os
import pkgutil
import subprocess
import sys

import repro_torch

PKG_DIR = os.path.dirname(repro_torch.__file__)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PKG_DIR))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15  # every module of the slice was imported


def test_no_source_file_names_jax_or_reference():
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                text = open(os.path.join(root, f)).read()
                for needle in ("import jax", "from jax", "from repro ",
                               "from repro.", "import repro\n",
                               "import repro."):
                    if needle in text:
                        offenders.append((f, needle))
    assert not offenders, offenders
    assert len(list(pkgutil.walk_packages([PKG_DIR]))) > 0
