"""Build and bind the hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` (one process per source,
all started together) and link into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a cold build
takes seconds).  The build happens at first use, into
``_build/<hash>/`` beside this file (listed in ``.gitignore``), keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as is.

Every launcher in the library returns the ``cudaGetLastError()`` code of
its launch; ``check`` raises on a non-zero code.  ``ptxas -v`` reports
every kernel's registers, shared memory and spills; the build keeps that
report as ``ptxas.log`` beside the library (``ptxas_summary``).

No ``--use_fast_math``: it turns ``/`` into approximate division, which
would break the rebucket kernel's bit-identity with its plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIB_NAME = "libpylamp_torch_kernels.so"
PTXAS_LOG = "ptxas.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the launchers (csrc/*.cu); every one returns the launch's
# cudaError_t as an int
SIGNATURES = {
    # vx, vy, p, rx, ry, rc, the solve's SaddleArgs (host struct: eta_s,
    # eta_n, kk, ny, nx, dx, dy, the four wall signs, periodic), stream
    "launch_saddle": [_P] * 8,
    # vx, vy, rx, ry, the level's SaddleArgs (host struct, kk = kbnd),
    # stream
    "launch_momentum": [_P] * 6,
    # x, y, T, mat, valid, material table (host), out pointers (host
    # array of 13), ny, nx, K, dx, dy, flags (with the periodic bit),
    # strip width, chunk rows, unit slots, units a cell row, threads a
    # node, stream
    "launch_m2g": [_P] * 7 + [_I, _I, _I, _F, _F] + [_I] * 6 + [_P],
    # x, y, valid, vx_p, vy_p, dt, out_x, out_y, ny, nx, K, dx, dy,
    # x_lo, x_hi, y_lo, y_hi, reach, periodic, lx, 1/lx, tile rows, tile
    # columns, slots a round, stream
    "launch_advect": ([_P] * 8 + [_I, _I, _I] + [_F] * 6 + [_I, _I, _F, _F]
                      + [_I] * 3 + [_P]),
    # x, y, T, mat, valid, ox, oy, oT, omat, ovalid, dropped (int64), ny,
    # nx, K, dx, dy, strip width, chunk rows, periodic, stream
    "launch_rebucket": [_P] * 11 + [_I, _I, _I, _F, _F, _I, _I, _I, _P],
    # ex, ey, rx, ry, eta_s, eta_n, coeffs, kb, ox, oy, fx, fy, ny, nx, dx,
    # dy, s_top, s_bottom, s_left, s_right, iters, h, zero_init, emit,
    # tile rows, periodic, stream
    "launch_cheb": [_P] * 12 + [_I, _I] + [_F] * 6 + [_I] * 6 + [_P],
    # levels (host array of CoarseLevel), the same on the device, nlev, rx,
    # ry, ex, ey, coeffs, kbnds, maxit, pre, post, coarse_iters, s_top,
    # s_bottom, s_left, s_right, dynamic shared bytes, stream
    "launch_coarse_vcycle": ([_P, _P, _I] + [_P] * 6 + [_I] * 4 + [_F] * 4
                             + [_I, _P]),
    # per-shard kernels: S shards in one launch
    # vx, vy, p (or null), es, en, kcont, rx, ry, rc (or null), S, by, bx,
    # dx, dy, stream
    "launch_saddle_block": [_P] * 9 + [_I] * 3 + [_F] * 2 + [_P],
    # ex, ey, rx, ry, es, en, flags, coeffs, kb, ox, oy, fx, fy, S, by, bx,
    # h, dx, dy, s_top, s_bottom, s_left, s_right, iters, zero_init, emit,
    # tile rows, stream
    "launch_cheb_block": [_P] * 13 + [_I] * 4 + [_F] * 6 + [_I] * 4 + [_P],
    # x, y, T, mat, valid, bases, material table (host), out pointers
    # (host array of 13), S, ny, nx, by, bx, K, dx, dy, flags, strip
    # width, chunk rows, unit slots, units a cell row, threads a node,
    # stream
    "launch_m2g_block": [_P] * 8 + [_I] * 6 + [_F, _F] + [_I] * 6 + [_P],
    # x, y, valid, vx_ext, vy_ext, bases, dt, out_x, out_y, S, ny, nx, by,
    # bx, K, dx, dy, x_lo, x_hi, y_lo, y_hi, reach, periodic, lx, 1 / lx,
    # tile rows, tile columns, slots a round, stream
    "launch_advect_block": ([_P] * 9 + [_I] * 6 + [_F] * 6 + [_I, _I, _F, _F]
                            + [_I] * 3 + [_P]),
    # x, y, T, mat, valid, bases, ox, oy, oT, omat, ovalid, arrivals, S,
    # ny, nx, by, bx, K, dx, dy, strip width, chunk rows, periodic, stream
    "launch_rebucket_block": [_P] * 12 + [_I] * 6 + [_F, _F, _I, _I, _I, _P],
    # occupancy queries, int[6] out: kernel 5 at (depth, tile rows,
    # periodic), kernel 8 at (depth, tile rows), kernel 6 at its dynamic
    # shared bytes, kernels 1 and 7 at (periodic), kernel 9 at (with p),
    # kernels 4 and 12 at (K, strip width, periodic), kernels 2 and 10 at
    # (strip width, unit slots, threads a node, flags), kernels 3 and 11
    # at (tile rows, tile columns, slots a round, periodic)
    "cheb_kernel_info": [_I, _I, _I, _P],
    "cheb_block_kernel_info": [_I, _I, _P],
    "saddle_kernel_info": [_I, _P],
    "momentum_kernel_info": [_I, _P],
    "saddle_block_kernel_info": [_I, _P],
    "rebucket_kernel_info": [_I, _I, _I, _P],
    "rebucket_block_kernel_info": [_I, _I, _I, _P],
    "m2g_kernel_info": [_I, _I, _I, _I, _P],
    "m2g_block_kernel_info": [_I, _I, _I, _I, _P],
    "advect_kernel_info": [_I, _I, _I, _I, _P],
    "advect_block_kernel_info": [_I, _I, _I, _I, _P],
    "coarse_vcycle_kernel_info": [_I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build only on "
            "a machine with the CUDA toolkit")
    return found


@functools.cache
def build() -> tuple[pathlib.Path, float]:
    """Compile the library if its hash is new; returns (path, build
    seconds; 0.0 when an up-to-date build was found)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        # one nvcc per source, all at once; then one link
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                   str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed, report = [], []
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}\n{err}")
            report.append(f"== {cmd[-1]}\n{out}{err}")
        (out_dir / PTXAS_LOG).write_text("\n".join(report))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        # link to a temporary name, then rename: concurrent builds never
        # load a half-written library
        tmp = os.path.join(work, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def ptxas_summary() -> list[dict]:
    """Every entry function of the current build's ``ptxas -v`` report: its
    source, (mangled) name, registers, static shared bytes and spill
    bytes."""
    import re

    path, _ = build()
    rows, src, fn = [], None, None
    for line in (path.parent / PTXAS_LOG).read_text().splitlines():
        if line.startswith("== "):
            src = pathlib.Path(line[3:].strip()).name
        elif m := re.search(r"Compiling entry function '([^']+)'", line):
            fn = dict(source=src, function=m.group(1), registers=None,
                      smem=0, spill_stores=0, spill_loads=0)
            rows.append(fn)
        elif fn is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            fn["spill_stores"], fn["spill_loads"] = map(int, m.groups())
        elif fn is not None and (m := re.search(r"Used (\d+) registers",
                                                line)):
            fn["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                fn["smem"] = int(sm.group(1))
    return rows


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every launcher's argtypes set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pylamp_error_string.argtypes = [ctypes.c_int]
    lib.pylamp_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str):
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        msg = library().pylamp_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {code} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def raw_stream(index: int) -> int:
    """The current stream's handle on CUDA device ``index`` (a CUDA
    tensor's ``device.index``), as ``stream_ptr`` gives it but without
    building a Stream object: PyTorch's own accessor, 0.1-0.3 us of host
    time against 3-6 us (``kernel_ab.py`` on an H100 node)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)
