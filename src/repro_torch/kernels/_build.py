"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
under ``build/kernels/`` at the repository root (git-ignored) and loaded with
``ctypes``. The library name carries a digest of the source and the flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing is built
or loaded when a module is imported: the first call of a kernel on a CUDA
tensor does it, or :func:`build_all` does it for several kernels at once with
one ``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


class CudaKernel:
    """One kernel library: its source, its C signatures, its launch count.

    ``signatures`` maps each exported C function to ``(restype, argtypes)``.
    ``launches`` is a plain counter that the Python wrapper bumps each time
    it launches the kernel, and nowhere else; where the library holds
    several variants of the kernel, ``variant_launches`` counts each.
    """

    def __init__(self, source: str,
                 signatures: Dict[str, Tuple[object, Tuple[object, ...]]],
                 variants: Tuple[str, ...] = ()):
        self.source = CSRC / source
        self.signatures = {
            **signatures,
            "repro_cuda_error_string": (ctypes.c_char_p, (ctypes.c_int,))}
        self.launches = 0
        self.variant_launches = dict.fromkeys(variants, 0)
        self._lib = None

    def count(self, variant: str) -> None:
        """One launch of ``variant``."""
        self.launches += 1
        self.variant_launches[variant] += 1

    def reset(self) -> None:
        self.launches = 0
        self.variant_launches = dict.fromkeys(self.variant_launches, 0)

    @property
    def target(self) -> Path:
        return _target(self.source)

    @property
    def build_log(self) -> Path:
        return self.target.with_suffix(".log")

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.target))
            for name, (restype, argtypes) in self.signatures.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            self._lib = lib
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a C entry returned a CUDA error code (the
        ``cudaGetLastError()`` after its launches, or its own refusal)."""
        if rc != 0:
            msg = self.lib().repro_cuda_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all running at once. Raises with the compiler's output if any
    build fails. The compiler's report (``-Xptxas=-v``: registers, shared
    memory, spills) is kept in ``<library>.log`` beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k in kernels:
        out = k.target
        if out.is_file():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        procs.append((k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for k, tmp, proc in procs:
        log, _ = proc.communicate()
        k.build_log.write_text(log)
        if proc.returncode != 0:
            failed.append(f"{k.source.name} (nvcc exit {proc.returncode}):\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, k.target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def row_strides(t, n: int) -> list:
    """The first ``n`` strides of ``t``; an axis of length 1 is only ever
    read at index 0, so its stride is moot and passed as 0."""
    return [0 if t.shape[i] == 1 else t.stride(i) for i in range(n)]


def stream_ptr() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd is on and any of ``tensors`` requires grad: the
    hand kernel writes its output outside autograd and has no backward (as
    the reference's ``pallas_call``, through which ``jax.grad`` fails), so
    its result would carry no gradient and the inputs' would be lost
    without a word."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward: call it on inputs that do "
            f"not require grad, or under torch.no_grad(); a model trains on "
            f"the plain path (build_model(cfg) without use_pallas)")
