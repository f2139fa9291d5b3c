"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/seqrec_tpu_torch/lib<name>-<digest>.so`` at the root of the
checkout, where ``digest`` hashes the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew
and an unchanged one is reused. Nothing here includes
PyTorch's headers: a build takes seconds. Pointers and the stream cross
into C as ``ctypes.c_void_p``; every C entry point returns
``cudaGetLastError()`` after its launches and the wrapper raises if it is
not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "seqrec_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills in the build log
]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def _library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [source_path(name), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build(names) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the compiler log of each source
    compiled now; raises if any compilation failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {name: _library_path(name) for name in names}
    jobs = {}
    try:
        for name, target in todo.items():
            if os.path.exists(target):
                continue
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, target)
        logs, failed = {}, []
        for name, (proc, tmp, target) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode:
                failed.append(name)
            else:
                os.replace(tmp, target)
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(_library_path(name))
        return _loaded[name]
