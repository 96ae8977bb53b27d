"""Kernel build: compiles ``csrc/<name>.cu`` with nvcc for Hopper
(``sm_90a``) into a shared library with a plain C interface and loads it
with ctypes. The build runs at first use into ``visionworkbench_torch/_build``
(listed in ``.gitignore``), named by a hash of the source and the flags, so
an edited source is rebuilt. A missing nvcc or a failed build raises; there
is no fallback.

``build()`` starts one nvcc per source, all together, and waits for all;
``load()`` builds a source together with its ``COMPANIONS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sweep", "speckle", "sgm_scan", "mgm_scan", "sgm_path_scan",
           "mgm_cluster_scan", "sgm_wta")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# The limits of csrc/mgm_scan.cu's register-carry instances (SGM and MGM),
# given to nvcc as macros and read by ops/sgm_scan.py:_mgm_variant,
# _scan_variant and _cluster_variant: disparity cells a lane (sy * sx) and
# lanes a block (threads a block; one block a line, or MGM lines over a
# cluster of up to CLUSTER_MAX_BLOCKS blocks).
MGM_MAX_CELLS = 16
MGM_MAX_LANES = 512
# The limits of csrc/sgm_path_scan.cu (scan_bidir, one warp per path line),
# read by ops/sgm_scan.py:_path_scan_variant and _path_scan_lines:
# disparity cells a line (its instances hold 1, 2, 4, ... these / 32 cells
# a thread) and lines (warps) a block.
PATH_SCAN_MAX_CELLS = 512
PATH_SCAN_MAX_LINES = 8
# The limits of csrc/mgm_cluster_scan.cu (MGM grids of more than
# MGM_MAX_CELLS cells, a line's lanes over the blocks of a thread-block
# cluster), read by ops/sgm_scan.py:_cluster_variant: disparity cells a
# lane (up to these / 32 cells a thread), blocks a cluster (16: the H100's
# non-portable most; csrc/mgm_scan.cu's clusters too) and threads a block.
CLUSTER_MAX_CELLS = 512
CLUSTER_MAX_BLOCKS = 16
CLUSTER_MAX_THREADS = 512
# The layout and limits of csrc/sweep.cu's band kernels (band_sweep_kernel:
# abs/sq; band_census_kernel: census), read by ops/sweep.py:_sweep_variant,
# _band_geometry and _census_band_geometry: output rows a block, output
# pixels a row thread, the instances' bounds on kw and kh (one instance each
# a cost or a census word count), threads a block.
SWEEP_BAND_ROWS = 16
SWEEP_SEG = 8
SWEEP_BAND_K = (16, 24)
SWEEP_BAND_MAX_THREADS = 256
DEFINES = {"mgm_scan": (f"-DVW_MGM_MAX_CELLS={MGM_MAX_CELLS}",
                        f"-DVW_MGM_MAX_LANES={MGM_MAX_LANES}",
                        f"-DVW_CLUSTER_MAX_BLOCKS={CLUSTER_MAX_BLOCKS}"),
           "sgm_path_scan": (f"-DVW_PATH_MAX_CELLS={PATH_SCAN_MAX_CELLS}",
                             f"-DVW_PATH_MAX_LINES={PATH_SCAN_MAX_LINES}"),
           "mgm_cluster_scan": (f"-DVW_CLUSTER_MAX_CELLS={CLUSTER_MAX_CELLS}",
                                f"-DVW_CLUSTER_MAX_BLOCKS={CLUSTER_MAX_BLOCKS}",
                                f"-DVW_CLUSTER_MAX_THREADS={CLUSTER_MAX_THREADS}"),
           "sweep": (f"-DVW_SWEEP_BAND_ROWS={SWEEP_BAND_ROWS}",
                     f"-DVW_SWEEP_SEG={SWEEP_SEG}",
                     f"-DVW_SWEEP_BAND_K0={SWEEP_BAND_K[0]}",
                     f"-DVW_SWEEP_BAND_K1={SWEEP_BAND_K[1]}",
                     f"-DVW_SWEEP_BAND_MAX_THREADS={SWEEP_BAND_MAX_THREADS}")}
# The sources built beside a source at its first load, in parallel with it:
# every SGM/MGM scan is followed by the winner-take-all step, so the first
# scan's build also builds csrc/sgm_wta.cu and its first call finds it built.
COMPANIONS = {n: ("sgm_wta",) for n in ("sgm_scan", "mgm_scan", "sgm_path_scan",
                                         "mgm_cluster_scan")}


_loaded: Dict[str, ctypes.CDLL] = {}


def flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + DEFINES.get(name, ())


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.access(os.path.join(cand, "bin", "nvcc"), os.X_OK):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("visionworkbench_torch: nvcc not found (set "
                           "CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build the named kernels that are not built yet, one nvcc each, all
    started together. Returns ``{name: library path}``; raises on failure.
    Each build's compiler messages (``-Xptxas=-v``: registers, shared
    memory, spills) are kept beside the library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("visionworkbench_torch: kernel build failed: "
                           + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed (with
    its ``COMPANIONS``)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name, *COMPANIONS.get(name, ())])[name]))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"visionworkbench_torch: {what} launch failed "
                           f"with cudaError_t {err}")
