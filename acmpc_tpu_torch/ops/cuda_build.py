"""Build a CUDA source of this package into a shared library and load it.

Each ``csrc/*.cu`` file exposes a plain C interface, so it compiles with
``nvcc`` alone in seconds (no PyTorch headers) and binds with ``ctypes``.
The library goes into ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the source, every ``csrc/*.cuh`` header it
may include, the flags, the compiler and the card's architecture: a stale
build from other source or headers, another compiler or another card is
never loaded. The compiler's report (``-Xptxas=-v``: registers, shared
memory and spills of each kernel) is kept beside the library as
``<name>.log``. ``defines`` compile a variant of a source (``-D`` flags,
part of the hash), such as a kernel's stage stamps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Hopper only: the port targets the H100 (sm_90a keeps wgmma/setmaxnreg
# available to later kernels)
_ARCH = {(9, 0): "90a"}
_FLAGS = (
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_library(source_name: str, device: torch.device, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` for ``device``'s architecture (once
    per content hash) and load it."""
    capability = torch.cuda.get_device_capability(device)
    arch = _ARCH.get(capability)
    if arch is None:
        raise RuntimeError(
            f"no build target for compute capability {capability}; "
            "the CUDA kernels are written for Hopper (sm_90a)"
        )
    nvcc = _nvcc()
    source = CSRC / source_name
    version = subprocess.run(
        [nvcc, "--version"], check=True, capture_output=True, text=True
    ).stdout
    gencode = f"-gencode=arch=compute_{arch},code=sm_{arch}"
    flags = (*_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join((*flags, gencode)).encode() + version.encode())
    key = digest.hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-sm{arch}-{key}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent build never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            done = subprocess.run(
                [nvcc, gencode, *flags, "-o", tmp, str(source)],
                check=True,
                capture_output=True,
                text=True,
            )
            out.with_suffix(".log").write_text(done.stdout + done.stderr)
            os.replace(tmp, out)
        except subprocess.CalledProcessError as err:
            raise RuntimeError(f"nvcc failed on {source}:\n{err.stderr}") from err
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(out))
