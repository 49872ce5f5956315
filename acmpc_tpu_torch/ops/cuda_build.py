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

``build_host_library`` is the host-compiler sibling for the C++ sources
(``csrc/*.cpp``): built with ``c++`` (or ``$CXX``) into the same
directory, named by a hash of the source, the flags, the compiler and its
version, and the machine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
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


# the host C++ compiler of build_host_library
HOST_CXX = os.environ.get("CXX", "c++")
_HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


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
    _compile([nvcc, gencode, *flags], source, out)
    return ctypes.CDLL(str(out))


def build_host_library(source_name: str) -> ctypes.CDLL:
    """Compile the C++ source ``csrc/<source_name>`` with the host
    compiler (once per content hash) and load it. Raises ``RuntimeError``
    when the compiler is missing or fails."""
    cxx = shutil.which(HOST_CXX)
    if cxx is None:
        raise RuntimeError(
            f"host C++ compiler {HOST_CXX!r} not found: set CXX or put c++ on PATH"
        )
    source = CSRC / source_name
    try:
        version = subprocess.run(
            [cxx, "--version"], check=True, capture_output=True, text=True
        ).stdout
    except (OSError, subprocess.CalledProcessError) as err:
        raise RuntimeError(f"host C++ compiler {cxx} does not run: {err}") from err
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((cxx, *_HOST_FLAGS, platform.machine())).encode())
    digest.update(version.encode())
    out = BUILD_DIR / f"{source.stem}-host-{digest.hexdigest()[:16]}.so"
    _compile([cxx, *_HOST_FLAGS], source, out)
    return ctypes.CDLL(str(out))


def _compile(command: list, source: pathlib.Path, out: pathlib.Path) -> None:
    """Run ``command -o <tmp> source`` unless ``out`` exists, keep the
    compiler's report as ``out.log`` and move the library into place."""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent build never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            done = subprocess.run(
                [*command, "-o", tmp, str(source)],
                check=True,
                capture_output=True,
                text=True,
            )
            out.with_suffix(".log").write_text(done.stdout + done.stderr)
            os.replace(tmp, out)
        except subprocess.CalledProcessError as err:
            name = pathlib.Path(command[0]).name
            raise RuntimeError(f"{name} failed on {source}:\n{err.stderr}") from err
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
