"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``meso_tpu_torch/csrc/`` is compiled with ``nvcc``
for ``sm_90a`` into an object file, all of them at once in parallel, and the
objects are linked into one shared library with a plain C interface, which
is loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The ``*.cuh`` headers beside them are included by the sources and never
compiled on their own. The library goes into ``build/meso_tpu_torch/`` at
the repository root, named by a hash of the sources, the headers and the
flags, at first use; a later call with the same files loads it without
compiling. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "meso_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
SIGNATURES = {
    # tag, h, n, step, seed, rounds, stream
    "meso_particle_hash": (_P, _P, _I, _U, _U, _I, _P),
    # x, v, h, valid, a, gamma, sigma, rc, box_lo, box_hi, table, f, vir,
    # nx, k, xr, width, n_blocks, threads, list_cap, smem_bytes, min_image,
    # tea, need_virial, dt_inv_sqrt, step, seed, rounds, stream
    "meso_pair_dpd_v3": (_P,) * 13 + (_I,) * 11 + (_F, _U, _U, _I, _P),
    # x, v, tag, typ, valid, h, a, gamma, sigma, rc, n_types, excl,
    # excl_rows, n_excl, excl_w, box_lo, box_hi, table, f, vir, nx, k, xr,
    # width, n_blocks, threads, list_cap, smem_bytes, min_image, tea, debug,
    # dt_inv_sqrt, s_exp, step, seed, rounds, stream
    "meso_pair_dpd_v3_general": (_P,) * 10 + (_I, _P, _I, _I) + (_P,) * 6
    + (_I,) * 11 + (_F, _F, _U, _U, _I, _P),
    # h, out, n, salt, stream
    "meso_uniform_stream": (_P, _P, _I, _U, _P),
    # x, v, t, tag, typ, valid, h, a, gamma, kappa, rc, n_types, box_lo,
    # box_hi, table, f, dtdt, vir, nx, k, xr, width, n_blocks, threads,
    # list_cap, smem_bytes, min_image, tea, dt_inv_sqrt, mass, cv, step,
    # seed, rounds, stream
    "meso_pair_edpd_v3": (_P,) * 11 + (_I,) + (_P,) * 6 + (_I,) * 10
    + (_F,) * 3 + (_U, _U, _I, _P),
    # x, v, c, tag, typ, valid, h, a, gamma, sigma, rc, n_types, kappa_c,
    # eps_c, box_lo, box_hi, table, f, dcdt, vir, nx, k, xr, ns, width,
    # n_blocks, threads, list_cap, smem_bytes, min_image, tea, dt_inv_sqrt,
    # rcc, s1, step, seed, rounds, stream
    "meso_pair_tdpd_v3": (_P,) * 11 + (_I,) + (_P,) * 8 + (_I,) * 11
    + (_F,) * 3 + (_U, _U, _I, _P),
    # model, tea, fb, ib, box_lo, box_hi, a, gamma, x3, rc, n_types, ch_h,
    # ch_typ, ch_ex, n_excl, excl_w, ns, kappa_c, eps_c, f, extra, vir, nx,
    # ny, nz, k, xr, table, width, n_blocks, threads, list_cap, smem_bytes,
    # dt_inv_sqrt, s_exp, mass, cv, rcc, s1, step, seed, rounds, stream
    "meso_pair_brick": (_I, _I) + (_P,) * 8 + (_I,) * 5 + (_P, _I)
    + (_P,) * 5 + (_I,) * 5 + (_P,) + (_I,) * 5 + (_F,) * 6
    + (_U, _U, _I, _P),
    # base, cx, valid, target, fits, overflow, n_in, nx, k, n_rows_yz, wrap,
    # stream (csrc/bucket_assign.cu)
    "meso_spill_assign": (_P,) * 6 + (_I,) * 5 + (_P,),
    # x, image, mask, lo, hi, x_out, image_out, key, n, nx, ny, nz, wrap,
    # stream (csrc/bucket_assign.cu)
    "meso_bucket_keys": (_P,) * 8 + (_I,) * 5 + (_P,),
    # src, dst, width, n_cols, order, target, fits, inv, cx, x_col,
    # image_col, lo, hi, nx, n_in, nr, stream (csrc/bucket_assign.cu)
    "meso_bucket_place": (_P,) * 3 + (_I,) + (_P,) * 5 + (_I,) * 2
    + (_P,) * 2 + (_I,) * 3 + (_P,),
    # x, tag, valid, owner, box_lo, box_hi, partners, max_partners, coeffs,
    # inv, f, missing, n, n_tags, style, store, stream (csrc/bonds.cu)
    "meso_pair_bonds": (_P,) * 7 + (_I,) + (_P,) * 4 + (_I,) * 4 + (_P,),
    # x, x_ref, mask, lo, hi, out, n, stream (csrc/bucket_assign.cu)
    "meso_max_displacement": (_P,) * 6 + (_I, _P),
    # n, key_bits, wrap (csrc/bucket_assign.cu)
    "meso_bucket_rebuild_bytes": (_I,) * 3,
    # x, image, mask, lo, hi, src, dst, width, n_cols, x_col, image_col,
    # work, overflow, n, nx, ny, nz, k, key_bits, wrap, stream
    "meso_bucket_rebuild": (_P,) * 8 + (_I,) * 3 + (_P,) * 2 + (_I,) * 7
    + (_P,),
    # x, v, f, image, inv_mass, per_row, move, lo, hi, x_out, v_out,
    # image_out, n, dt, c_v, c_x, wrap, stream (csrc/integrate.cu)
    "meso_initial_integrate": (_P,) * 5 + (_I,) + (_P,) * 6 + (_I,)
    + (_F,) * 3 + (_I, _P),
    # v, f_old, f_new, inv_mass, per_row, move, v_out, n, c_v, stream
    "meso_final_integrate": (_P,) * 4 + (_I, _P, _P, _I, _F, _P),
    # the probes (csrc/probes.cu)
    # x, offs, n_offs, out, rows, len, stream
    "meso_probe_dynroll": (_P, _P, _I, _P, _I, _I, _P),
    # x, jm, out, n, stream
    "meso_probe_cond": (_P, _P, _P, _I, _P),
    # a, b, c, batch, m, n, k, a_trans, stream
    "meso_probe_gemm": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # ai, bj, out, batch, stream
    "meso_probe_tile": (_P, _P, _P, _I, _P),
    # stack, iscal, offs, n_offs, out, k, len, mixer, rounds, ordering,
    # all_rows, stream
    "meso_probe_tea_roll": (_P, _P, _P, _I, _P) + (_I,) * 6 + (_P,),
    # view, out, ny, zc, plane, stream
    "meso_probe_null_stage": (_P, _P, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    """Path of nvcc from CUDA_HOME, PyTorch's CUDA_HOME, or PATH."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    from torch.utils import cpp_extension
    homes.append(cpp_extension.CUDA_HOME)
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in CUDA_HOME, torch's CUDA_HOME and PATH): "
        "the CUDA kernels of meso_tpu_torch cannot be built")


def sources() -> list[Path]:
    """The translation units, one object file each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path(nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update(nvcc.encode())
    for src in headers() + sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmeso_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all; return their joined
    output, or raise naming each one that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}"
              for p, cmd, out in zip(procs, cmds, outs) if p.returncode]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build() -> Path:
    """Compile the sources if no library for them exists; return its path.
    The compiler's register and spill report is kept beside it (``.log``)."""
    nvcc = find_nvcc()
    out = library_path(nvcc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources(), objs)])
        lib = Path(tmp) / out.name
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(lib),
                          *map(str, objs)]])
        out.with_suffix(".log").write_text(log)
        os.replace(lib, out)
    return out


def stream_of(device) -> int:
    """The handle of the current CUDA stream on ``device`` (a CUDA
    torch.device), as the C entry points take it: read straight from the
    runtime where torch offers that, without building a Stream object at
    every launch."""
    import torch
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C
    function's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
