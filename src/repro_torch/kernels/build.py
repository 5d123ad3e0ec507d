"""Build of the port's CUDA sources into shared libraries bound by ctypes.

Each source under ``csrc/`` has a plain C interface. At first use it is
compiled with ``nvcc`` into ``build/torch_kernels/<hash>/lib<name>.so`` at
the repository root, keyed by a hash of the source and its flags (an edit
rebuilds), and the compiler's report (registers, spills) is kept beside
it as ``build.log``. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

# Target and output of every kernel library; each source adds its own flags.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA kernels need nvcc, and no CUDA toolkit was found "
                           "(set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library(source: Path, flags: tuple[str, ...]) -> Path:
    """Compile ``source`` with ``flags`` unless that pair was built already;
    returns the shared library's path."""
    src = source.read_bytes()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / f"lib{source.stem}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{source.stem}.{os.getpid()}.so"
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, check=False)
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def bind(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    """Set each function's argtypes and restype from ``signatures``
    (name -> (argtypes, restype)). A pointer or a 64-bit integer left to
    ctypes' default would be cut to 32 bits."""
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def ptxas_report(log: str, kernel: str) -> dict:
    """{template argument: {"registers", "spill_stores", "spill_loads"}} of
    each instance ``kernel<N>`` of an integer template in a build.log
    (``-Xptxas -v``). Under ``setmaxnreg`` the registers are the count at
    launch, not what a warpgroup takes after."""
    out, arg = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(kernel + r"ILi(\d+)E", line)
            arg = int(found.group(1)) if found else None
        elif arg is not None and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out.setdefault(arg, {}).update(spill_stores=int(stores), spill_loads=int(loads))
        elif arg is not None and re.search(r"Used \d+ registers", line):
            out.setdefault(arg, {})["registers"] = int(re.search(r"Used (\d+) registers",
                                                                 line).group(1))
    return out
