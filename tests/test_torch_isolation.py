"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``,
nor ``ml_dtypes`` (the GPU machine lacks it; the checkpoint reader carries
bfloat16 leaves through a ``uint16`` view instead)."""
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
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
        "'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.')))\n"
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
                               "import repro.", "import ml_dtypes",
                               "from ml_dtypes"):
                    if needle in text:
                        offenders.append((f, needle))
    assert not offenders, offenders
    assert len(list(pkgutil.walk_packages([PKG_DIR]))) > 0


def test_schedule_search_modules_are_walked():
    """The import walk above reaches the schedule-search slice's modules."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("core.perf_model", "sched", "sched.graph", "sched.allocate",
                "sched.simulate", "sched.search", "sched.executor",
                "sched.pricing", "sched.autotune", "obs.gap"):
        assert f"repro_torch.{mod}" in names, mod


def test_training_modules_are_walked():
    """The import walk above reaches the training slice's modules."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("data", "data.pipeline", "train.optimizer", "train.trainer",
                "train.checkpoint", "launch.train"):
        assert f"repro_torch.{mod}" in names, mod


def test_cnn_modules_are_walked():
    """The import walk above reaches the CNN slice's modules."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("core.cim_layer", "models.cnn", "configs.vgg16_cifar",
                "configs.resnet18_cifar"):
        assert f"repro_torch.{mod}" in names, mod
