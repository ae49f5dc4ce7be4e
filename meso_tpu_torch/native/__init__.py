"""Native (C++) host-side IO, built at first use with the system g++.

``mesoio.cpp`` is the port's own copy of the JAX package's frame codec
(tag-sorted LAMMPS text dumps and compact binary frames) as a CPython
extension (plain C API and buffer protocol), its module renamed
``_mesoio_torch`` so that it never shadows the JAX package's ``_mesoio``
in one process. ``load`` compiles it into ``build/meso_tpu_torch/`` at the
repository root, named by a hash of the source, the flags and the
interpreter's extension suffix (a later call loads it without compiling),
and imports it by path. A failed build raises with the compiler's output:
nothing falls back to a Python writer.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "mesoio.cpp"
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "meso_tpu_torch"
MODULE = "_mesoio_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def module_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    return BUILD_DIR / f"{MODULE}_{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the extension if no build of this source exists; return its
    path. Raises RuntimeError with g++'s output if the build fails."""
    out = module_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = ["g++", *CXX_FLAGS, f"-I{include}", str(SOURCE), "-o",
               str(tmp_out)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native IO build failed: {e}") from e
        if proc.returncode:
            raise RuntimeError(
                f"native IO build failed ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp_out, out)
    return out


@functools.lru_cache(maxsize=None)
def load():
    """The built extension module (building it first if needed)."""
    path = build()
    spec = importlib.util.spec_from_file_location(MODULE, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
