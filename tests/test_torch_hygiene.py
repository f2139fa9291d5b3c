"""Import hygiene and device policy of the PyTorch port."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import seqrec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(seqrec_tpu_torch.__path__, "seqrec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
banned = {"jax", "jaxlib", "optax", "ml_dtypes", "seqrec_tpu"}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), leaked)
"""

_NEW_MODULES = r"""
import importlib, sys
for name in ("seqrec_tpu_torch.data.native", "seqrec_tpu_torch.models.base", "seqrec_tpu_torch.data.dataset"):
    importlib.import_module(name)
from seqrec_tpu_torch.data import native
banned = {"jax", "jaxlib", "optax", "ml_dtypes", "seqrec_tpu"}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(native._lib is None and not native._lib_failed, "triton" in sys.modules, leaked)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of seqrec_tpu_torch, and chip_smoke.py, imported in a
    fresh interpreter, leaves jax, optax, ml_dtypes and seqrec_tpu (matched
    by exact top-level name: seqrec_tpu_torch starts with seqrec_tpu) out
    of sys.modules."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 15
    assert leaked.strip() == "[]"


def test_native_parser_and_dispatch_modules_import_clean():
    """The native parser's binding and the modules of the prefetch and
    K-step dispatch import neither jax nor the JAX package, and importing
    them builds and loads nothing (the parser is built at its first use)."""
    out = subprocess.run(
        [sys.executable, "-c", _NEW_MODULES], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False", "[]"]


_DATA = r"""
import importlib, pkgutil, sys
import seqrec_tpu_torch.data as data
names = sorted(m.name for m in pkgutil.walk_packages(data.__path__, "seqrec_tpu_torch.data."))
for name in names:
    importlib.import_module(name)
banned = {"pandas", "dateutil", "jax", "jaxlib", "optax", "ml_dtypes", "seqrec_tpu"}
leaked = sorted({m.split(".")[0] for m in sys.modules} & banned)
print(len(names), leaked)
"""


def test_data_modules_import_neither_pandas_nor_dateutil():
    """seqrec_tpu_torch/data/ (the preprocess among it) runs where pandas is
    missing: its modules, imported in a fresh interpreter, leave pandas and
    dateutil (and jax and the JAX package) out of sys.modules."""
    out = subprocess.run(
        [sys.executable, "-c", _DATA], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    n_modules, leaked = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 5
    assert leaked.strip() == "[]"


_PARALLEL = r"""
import importlib, pkgutil, sys
import seqrec_tpu_torch.parallel as par
import torch.distributed as dist
names = sorted(m.name for m in pkgutil.walk_packages(par.__path__, "seqrec_tpu_torch.parallel."))
for name in names:
    importlib.import_module(name)
banned = {"jax", "jaxlib", "optax", "ml_dtypes", "seqrec_tpu"}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(" ".join(names), leaked, dist.is_initialized())
"""


def test_parallel_modules_import_clean():
    """The mesh's modules (seqrec_tpu_torch/parallel/) import neither jax nor
    the JAX package, and importing them joins no process group."""
    out = subprocess.run(
        [sys.executable, "-c", _PARALLEL], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    *names, leaked, initialized = out.stdout.split()
    assert names == [f"seqrec_tpu_torch.parallel.{m}" for m in ("collectives", "columns", "distributed", "mesh",
                                                                 "topk")]
    assert (leaked, initialized) == ("[]", "False")


def test_cli_without_device_cpu_raises_when_no_gpu(synthetic_dataset):
    """Also for the lazy baselines, which do no device work."""
    import seqrec_tpu_torch.cli.test as test_cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the CLI runs on it")
    for flags in (["-m", "RNN", "--loss", "CCE", "--r_l", "8", "-i", "1"], ["-m", "POP"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test_cli.main(["-d", synthetic_dataset, *flags])


# the flags whose --mesh came with the last mesh slice (--lazy_updates,
# --bf16), and the model that now takes the mesh with them (each case's id
# names its model or flag)
LATER_SLICE = {
    "RNNSampling": (["-m", "RNN", "--loss", "BPR", "--sampling", "8", "--lazy_updates"], "RNNSampling"),
    "RNNMargin": (["-m", "RNN", "--loss", "hinge", "--lazy_updates"], "RNNMargin"),
    "--lazy_updates": (["-m", "RNN", "--loss", "CCE", "--lazy_updates"], "RNNOneHot"),
    "--bf16": (["-m", "RNN", "--loss", "CCE", "--bf16"], "RNNOneHot"),
    "RNNCluster": (["-m", "RNN", "--clusters", "4", "--loss", "Blackout", "--sampling", "8", "--bf16"], "RNNCluster"),
    "FISMCluster": (["-m", "FISM", "--clusters", "4", "--loss", "Blackout", "--sampling", "8", "--bf16"],
                    "FISMCluster"),
    # the autoencoder's CLI passes neither flag on (as in the JAX package)
    "StackedDenoisingAutoencoder": (["-m", "SDA", "-L", "8", "--bf16", "--lazy_updates"],
                                    "StackedDenoisingAutoencoder"),
}
LATER_SLICE_IDS = [f"flags{i}-{name}" for i, name in enumerate(LATER_SLICE)]


class _TookMesh(Exception):
    pass


def _assert_takes_mesh(monkeypatch, run, model: str) -> None:
    """The CLI's model takes the two-rank mesh: stopped right after
    ``set_mesh`` returns, with the mesh set."""
    from seqrec_tpu_torch.models.base import RNNBase

    set_mesh = RNNBase.set_mesh

    def took(self, mesh):
        set_mesh(self, mesh)
        raise _TookMesh(type(self).__name__, self.mesh is mesh)

    monkeypatch.setattr(RNNBase, "set_mesh", took)
    with pytest.raises(_TookMesh) as exc:
        run()
    assert exc.value.args == (model, True)


def two_rank_mesh(spec, device="cuda"):
    """A 2x1 mesh as rank 0 of two would build it, without a process group:
    a model refuses such a mesh before any collective."""
    from seqrec_tpu_torch.parallel import Mesh

    return Mesh(2, 1, 0, torch.device(device), {"data": None, "model": None})


@pytest.mark.parametrize("flags, model", list(LATER_SLICE.values()), ids=LATER_SLICE_IDS)
def test_cli_raises_not_implemented_outside_the_slice(synthetic_dataset, monkeypatch, flags, model):
    """The test CLI under a mesh of two ranks once refused --lazy_updates
    and --bf16; every model that takes a mesh now takes it with them."""
    import seqrec_tpu_torch.cli.test as test_cli

    monkeypatch.setattr(test_cli, "make_cli_mesh", two_rank_mesh)
    argv = ["-d", synthetic_dataset, "--r_l", "8", "-b", "8", "--device", "cpu", *flags, "--mesh", "2,1"]
    _assert_takes_mesh(monkeypatch, lambda: test_cli.main(argv), model)
