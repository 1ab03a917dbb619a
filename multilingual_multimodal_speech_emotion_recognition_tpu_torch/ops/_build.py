"""Build the port's CUDA sources with nvcc, load them with ctypes, guard their wrappers.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into `build/kernels/lib<name>-<hash>.so` at the root of the checkout
(listed in .gitignore). The hash covers the source and its flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. A source
that encodes TMA tensor maps (`cuTensorMapEncodeTiled`, which libcuda
exports and the CUDA runtime does not) links `-lcuda`. Nothing here runs
when a module is imported, so the port imports on a machine without nvcc
or a card; asking for a library there raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def link_flags(name: str) -> tuple:
    """`-lcuda` where csrc/<name>.cu calls `cuTensorMapEncodeTiled`."""
    return ("-lcuda",) if b"cuTensorMapEncodeTiled" in (CSRC / f"{name}.cu").read_bytes() else ()


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + link_flags(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> List[Path]:
    """Compile every csrc/<name>.cu whose library is not built yet, one
    nvcc process per source, all started together. The compiler's output
    (ptxas register and shared-memory report included) goes to
    build/kernels/<name>.log."""
    names = list(names)
    running = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(CSRC / f"{name}.cu"), *link_flags(name)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        running.append((name, proc, tmp, lib))
    failed = []
    for name, proc, tmp, lib in running:
        out, err = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(name) for name in names]


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use. Each entry
    point in `signatures` (its ctypes argument types) returns a CUDA error
    code, which `<name>_error_string` turns into text."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build_all([name])[0]))
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def launch(name: str, signatures: Dict[str, Sequence], entry: str,
           device: torch.device, *args) -> None:
    """Call `entry` of csrc/<name>.cu with `args` and the current stream of
    `device` (always the last argument); raise with CUDA's message when the
    launch fails. The kernel runs asynchronously."""
    lib = load(name, signatures)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())


def grad_wanted(tensors: Iterable[Optional[torch.Tensor]]) -> bool:
    """Whether autograd records and one of `tensors` (None skipped) wants a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def takes_plain(name: str, device: torch.device, tensors: Iterable[Optional[torch.Tensor]],
                hint: str = "run it under torch.no_grad() or torch.inference_mode()") -> bool:
    """Whether kernel `name`'s wrapper runs its plain version for a call on
    `device`: on the CPU where `grad_wanted(tensors)`, so that the result
    keeps its history; else it calls its op. Raises ValueError off cpu and
    cuda, RuntimeError with `hint` where a CUDA call wants a gradient."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    wanted = grad_wanted(tensors)
    if wanted and device.type == "cuda":
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; {hint}")
    return wanted
