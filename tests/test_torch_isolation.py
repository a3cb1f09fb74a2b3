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


def test_moe_slice_modules_are_walked():
    """The import walk above reaches the moe slice's configs and the
    grouped-product kernel's wrapper, and the kernel's source is in
    ``csrc/``."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("kernels.grouped_matmul", "configs.phi3_5_moe_42b_a6_6b",
                "configs.grok_1_314b", "configs.granite_8b",
                "configs.stablelm_12b", "configs.gemma3_27b"):
        assert f"repro_torch.{mod}" in names, mod
    assert os.path.exists(os.path.join(PKG_DIR, "csrc", "grouped_matmul.cu"))


def test_macro_sharding_modules_are_walked():
    """The import walk above reaches the macro-sharding slice's mesh module
    (``launch.shardings``) and the modules it threads through, and the
    sharded entry points sit in the block-sparse kernel's wrapper."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("launch.shardings", "launch.serve", "serve.batching",
                "serve.server", "core.deploy"):
        assert f"repro_torch.{mod}" in names, mod
    text = open(os.path.join(PKG_DIR, "kernels", "cim_bsr_matmul.py")).read()
    for entry in ("def bsr_matmul_sharded(", "def bsr_matmul_stacked_sharded("):
        assert entry in text, entry


def test_gateway_slice_modules_are_walked():
    """The import walk above reaches the gateway slice's modules: the
    tenant runtime, admission, the gateway loop and the bench history."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("gateway", "gateway.tenant", "gateway.admission",
                "gateway.gateway", "obs.history"):
        assert f"repro_torch.{mod}" in names, mod


def test_family_slice_modules_are_walked():
    """The import walk above reaches the hybrid, encdec and vlm slice's
    modules: the encoder-decoder model and the three configs."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("models.encdec", "models.transformer", "configs.zamba2_1_2b",
                "configs.whisper_tiny", "configs.llava_next_34b"):
        assert f"repro_torch.{mod}" in names, mod


def test_dry_run_slice_modules_are_walked():
    """The import walk above reaches the dry-run slice's modules."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for mod in ("launch.mesh", "launch.dryrun", "launch.shardings",
                "train.compression", "train.pipeline"):
        assert f"repro_torch.{mod}" in names, mod


def test_imports_make_no_process_group():
    """Importing ``repro_torch`` and every submodule creates no process
    group and imports no module of ``torch.testing._internal`` (where the
    fake store lives) beyond those ``import torch`` itself loads: only
    ``launch.mesh.make_production_mesh`` does, when called."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "internal = lambda: {m for m in sys.modules\n"
        "                    if m.startswith('torch.testing._internal')}\n"
        "before = internal()\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'): importlib.import_module(m.name)\n"
        "import torch.distributed as dist\n"
        "assert not (dist.is_available() and dist.is_initialized())\n"
        "bad = sorted(internal() - before)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PKG_DIR))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
