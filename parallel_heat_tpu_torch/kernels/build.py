"""Build the CUDA kernels with nvcc and load them with ctypes.

``python -m parallel_heat_tpu_torch.kernels.build [NAME ...]`` builds the
named kernels (all by default) and prints ptxas's report of each template
instance, by name: registers, spill stores and loads, stack and static
shared memory (:func:`ptxas_report`).

Each source under ``csrc/`` is compiled on first use, by one
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
call, into a shared library with a plain C interface under
``parallel_heat_tpu_torch/build/`` (listed in ``.gitignore``). The file
name carries a digest of the sources and flags, so an edited source is
rebuilt and never mixed with a stale library; nvcc's report is kept
beside it (:func:`build_log`). :func:`build` starts one nvcc per missing
library, all at once, and waits for all of them.

There is no fallback: when nvcc is missing or a source does not
compile, :class:`BuildError` carries nvcc's stderr to the caller.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)

# Entry point -> (source, argtypes). Pointers and the stream are
# c_void_p: anything narrower would cut a 64-bit address.
KERNELS = {
    "heat_a_resident": ("heat_a_resident.cu",
                        [_P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                         _I32, _I32, _I32, _F32, _F32, _F32, _P]),
    "heat_b_step": ("heat_b_step.cu",
                    [_P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                     _F32, _F32, _F32, _P]),
    "heat_c_tiled": ("heat_c_tiled.cu",
                     [_P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32,
                      _F32, _F32, _F32, _P]),
    "heat_e_temporal": ("heat_e_temporal.cu",
                        [_P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32,
                         _I32, _F32, _F32, _F32, _P]),
    "heat_e_uni_temporal": ("heat_e_uni_temporal.cu",
                            [_P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                             _I32, _I32, _F32, _F32, _F32, _P]),
    # u, out, res, (m, n), k, segment rows, warps, rows a stage, stages,
    # coefficients, stream
    "heat_i_tile_temporal": ("heat_i_tile_temporal.cu",
                             [_P, _P, _P, _I64, _I64, _I32, _I64, _I32,
                              _I32, _I32, _F32, _F32, _F32, _P]),
    "heat_i_uni_tile_temporal": ("heat_i_uni_tile_temporal.cu",
                                 [_P, _P, _P, _I64, _I64, _I32, _I64, _I32,
                                  _I32, _I32, _F32, _F32, _F32, _P]),
    # I's and I-uni's precision forms, a library each (32 instances, built
    # beside the float32 ones): their arguments, then the form
    # (csrc/heat_temporal.cuh kHeatForm*) before the coefficients.
    "heat_i_tile_temporal_bf16": ("heat_i_tile_temporal_bf16.cu",
                                  [_P, _P, _P, _I64, _I64, _I32, _I64, _I32,
                                   _I32, _I32, _I32, _F32, _F32, _F32, _P]),
    "heat_i_uni_tile_temporal_bf16": ("heat_i_uni_tile_temporal_bf16.cu",
                                      [_P, _P, _P, _I64, _I64, _I32, _I64,
                                       _I32, _I32, _I32, _I32, _F32, _F32,
                                       _F32, _P]),
    "heat_d_step3d": ("heat_d_step3d.cu",
                      [_P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32,
                       _F32, _F32, _F32, _F32, _P]),
    # grid, k, thread block (lanes, warps), rows, segment, prefetch, tma
    "heat_f_temporal3d": ("heat_f_temporal3d.cu",
                          [_P, _P, _P, _I64, _I64, _I64] + [_I32] * 7
                          + [_F32] * 4 + [_P]),
    # F's bfloat16 form, a library of its own (48 plane-loop instances, as
    # F's), so that its nvcc runs beside F's: F's arguments.
    "heat_f_temporal3d_bf16": ("heat_f_temporal3d_bf16.cu",
                               [_P, _P, _P, _I64, _I64, _I64] + [_I32] * 7
                               + [_F32] * 4 + [_P]),
    "heat_m_ensemble": ("heat_m_ensemble.cu",
                        [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32,
                         _I32, _I32, _I32, _I32, _F32, _F32, _F32, _P]),
    # The transfer kernels take their launch record (csrc/heat_mg.cuh
    # HeatMgTransfer, ops/multigrid.py _TransferArgs) by address, then
    # source, output and stream.
    "heat_mg_restrict": ("heat_mg_restrict.cu", [_P, _P, _P, _P]),
    "heat_mg_prolong": ("heat_mg_prolong.cu", [_P, _P, _P, _P]),
    # The sharded 2D block kernels (csrc/heat_g.cuh): the pieces form
    # takes u, tail, halo_n, halo_s, the assembled forms one buffer.
    "heat_g_block_padded": ("heat_g_block_padded.cu",
                            [_P, _P, _P] + [_I64] * 6 + [_I32] * 5
                            + [_F32] * 3 + [_P]),
    "heat_g_block_circular": ("heat_g_block_circular.cu",
                              [_P, _P, _P] + [_I64] * 6 + [_I32] * 5
                              + [_F32] * 3 + [_P]),
    "heat_g_block_fused": ("heat_g_block_fused.cu",
                           [_P] * 6 + [_I64] * 6 + [_I32] * 5 + [_F32] * 3
                           + [_P]),
    "heat_g_block_uniform": ("heat_g_block_uniform.cu",
                             [_P] * 6 + [_I64] * 6 + [_I32] * 5
                             + [_F32] * 3 + [_P]),
    # The band kernel takes a host table of blocks (ops/
    # stencil_kernels_block.py _BandEntry), their count and the load.
    "heat_g_band_fix": ("heat_g_band_fix.cu",
                        [_P, _I32, _I32, _P] + [_I64] * 4 + [_I32] * 4
                        + [_F32] * 3 + [_P]),
    # The sharded 3D block kernels: grid, block and origin (9 int64),
    # then halos; H (csrc/heat_h_block_3d.cu, F's plane loop) the circular
    # block's row pitch, k, thread block (lanes, warps), rows, segment,
    # prefetch and tma; H-fused (csrc/heat_h.cuh) defer_x, tma, k, thread
    # block, rows and segment.
    "heat_h_block_3d": ("heat_h_block_3d.cu",
                        [_P] * 3 + [_I64] * 9 + [_I32] * 3 + [_I64]
                        + [_I32] * 4 + [_I64] + [_I32] * 2 + [_F32] * 4
                        + [_P]),
    "heat_h_block_3d_fused": ("heat_h_block_3d_fused.cu",
                              [_P] * 7 + [_I64] * 9 + [_I32] * 9 + [_I64]
                              + [_F32] * 4 + [_P]),
    # The 3D band takes a host table of blocks (ops/
    # stencil_kernels_block_3d.py _BandEntry3D), their count and the load;
    # then grid, block, halos (y, z), k, thread block, rows and prefetch.
    "heat_h_band_fix_3d": ("heat_h_band_fix_3d.cu",
                           [_P, _I32, _I32, _P] + [_I64] * 6 + [_I32] * 7
                           + [_F32] * 4 + [_P]),
    # The bfloat16 forms of the sharded 3D family, a library each (as
    # F's), so that their nvccs run beside their float32 twins': their
    # twins' arguments.
    "heat_h_block_3d_bf16": ("heat_h_block_3d_bf16.cu",
                             [_P] * 3 + [_I64] * 9 + [_I32] * 3 + [_I64]
                             + [_I32] * 4 + [_I64] + [_I32] * 2
                             + [_F32] * 4 + [_P]),
    "heat_h_block_3d_fused_bf16": ("heat_h_block_3d_fused_bf16.cu",
                                   [_P] * 7 + [_I64] * 9 + [_I32] * 9
                                   + [_I64] + [_F32] * 4 + [_P]),
    "heat_h_band_fix_3d_bf16": ("heat_h_band_fix_3d_bf16.cu",
                                [_P, _I32, _I32, _P] + [_I64] * 6
                                + [_I32] * 7 + [_F32] * 4 + [_P]),
}
# Entry points that live in another kernel's library: name -> (that
# kernel, argtypes). The storage-precision forms of kernels A, B, C, D,
# E, E-uni, M and of the sharded 2D family G (bfloat16 storage, and E's
# and E-uni's float32 carry of accumulate="f32chunk") are compiled into
# their float32 kernels' sources, so one nvcc builds both; F's, I's,
# I-uni's and the sharded 3D family's (H, H-fused, the 3D band) have
# sources of their own (KERNELS).
ENTRIES = {
    "heat_a_resident_bf16": ("heat_a_resident",
                             KERNELS["heat_a_resident"][1]),
    "heat_b_step_bf16": ("heat_b_step", KERNELS["heat_b_step"][1]),
    "heat_c_tiled_bf16": ("heat_c_tiled", KERNELS["heat_c_tiled"][1]),
    "heat_m_ensemble_bf16": ("heat_m_ensemble",
                             KERNELS["heat_m_ensemble"][1]),
    "heat_d_step3d_bf16": ("heat_d_step3d", KERNELS["heat_d_step3d"][1]),
    # The sharded 2D block kernels' bfloat16 forms: their float32
    # siblings' arguments.
    **{name + "_bf16": (name, KERNELS[name][1])
       for name in ("heat_g_block_padded", "heat_g_block_circular",
                    "heat_g_block_fused", "heat_g_block_uniform",
                    "heat_g_band_fix")},
    # u, out, res, (m, n), k, tile, thread block, form, coefficients, stream
    "heat_e_temporal_bf16": ("heat_e_temporal",
                             [_P, _P, _P, _I64, _I64] + [_I32] * 6
                             + [_F32] * 3 + [_P]),
    "heat_e_uni_temporal_bf16": ("heat_e_uni_temporal",
                                 [_P, _P, _P, _I64, _I64] + [_I32] * 6
                                 + [_F32] * 3 + [_P]),
}
# The measurement tools' kernels (parallel_heat_tpu_torch/tools/): built
# and loaded like the kernels above, but no path of the solver runs them.
TOOLS = {
    # variant, then heat_a_resident's arguments
    "heat_probe_kernel": ("heat_probe_kernel.cu",
                          [_I32] + KERNELS["heat_a_resident"][1]),
    # kind, chain depth, stack, out, (members, rows, cols), passes,
    # thread block, then a, b, a0, cx, cy and the stream
    "heat_probe_vpu_roofline": ("heat_probe_vpu_roofline.cu",
                                [_I32, _I32, _P, _P] + [_I32] * 6
                                + [_F32] * 5 + [_P]),
    # variant, then heat_e_uni_temporal's arguments
    "heat_probe_temporal": ("heat_probe_temporal.cu",
                            [_I32] + KERNELS["heat_e_uni_temporal"][1]),
    "heat_probe_ab_temporal": ("heat_probe_ab_temporal.cu",
                               [_I32] + KERNELS["heat_e_uni_temporal"][1]),
    "heat_probe_split_copy": ("heat_probe_split_copy.cu",
                              [_I32] + KERNELS["heat_e_uni_temporal"][1]),
    # load, a, b, elem, check, (m, ca), wa, sa, cb, wb, rows, k, blocks,
    # thread block, stream
    "heat_probe_gather_dma": ("heat_probe_gather_dma.cu",
                              [_I32] + [_P] * 4 + [_I64] * 2 + [_I32] * 2
                              + [_I64] + [_I32] * 6 + [_P]),
    # stack, out, (members, rows, width), lo, band rows, sweeps, thread
    # block, stream
    "heat_probe_sweep_width": ("heat_probe_sweep_width.cu",
                               [_P, _P] + [_I32] * 8 + [_P]),
    "heat_probe_store_align": ("heat_probe_store_align.cu",
                               [_P, _P] + [_I32] * 8 + [_P]),
    # kernel (0 A, 1 E-uni), neighbour form, then heat_a_resident's
    # arguments (E-uni ignores xch and depth)
    "heat_probe_roll_pad": ("heat_probe_roll_pad.cu",
                            [_I32, _I32] + KERNELS["heat_a_resident"][1]),
    # variant, then heat_f_temporal3d's arguments
    "heat_probe_xslab_overlap": ("heat_probe_xslab_overlap.cu",
                                 [_I32] + KERNELS["heat_f_temporal3d"][1]),
    # the kernel audit's fixture: variant, u, out, off, rows, strip rows,
    # stream
    "heat_probe_fixture": ("heat_probe_fixture.cu",
                           [_I32, _P, _P, _P, _I64, _I32, _P]),
}
# Helpers the solver's paths use beside the kernels: built and loaded
# the same way, but no TPU kernel's counterpart. The device loop's
# conditional nodes (utils/device_loop.py): op, four handles or
# pointers, and three handles out.
HELPERS = {
    "heat_graph_loop": ("heat_graph_loop.cu",
                        [_I32, _P, _P, _P, _P, ctypes.POINTER(_P)]),
}
_COMMON = ("heat_common.cuh", "heat_temporal.cuh", "heat_i_loop.cuh",
           "heat_g.cuh", "heat_tma.cuh", "heat_temporal3d.cuh", "heat_h.cuh",
           "heat_a.cuh", "heat_e_uni.cuh", "heat_probe_sweep.cuh",
           "heat_f.cuh", "heat_f_block.inc", "heat_mg.cuh", "heat_hc.cuh",
           "heat_hb.cuh")

# nvcc's output of each build in this process (ptxas register and
# shared-memory report), by kernel name; also written beside the library.
BUILD_LOG: Dict[str, str] = {}
# Seconds from the start of each build in this process to the end of its
# nvcc, by kernel name (the nvccs run at once).
BUILD_SECONDS: Dict[str, float] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


# A ptxas report line ("-Xptxas -v"), and a template instance's mangled
# name: _Z<len><name>I<args>E... with args L<type><value>E.
_PTXAS_ENTRY = re.compile(r"(?:Compiling entry function|Function properties "
                          r"for) '?(_Z\w+)'?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?"
                         r"(?:, \d+ bytes cumulative stack size)?"
                         r"(?:, (\d+) bytes smem)?")
_TEMPLATE_ARG = re.compile(r"L([a-z])(n?\d+)E")


def demangle(symbol: str) -> str:
    """``name<a, b, ...>`` of a mangled function template instance whose
    arguments are integers or booleans (``_Z29heat_..._kernelILi3ELi2ELb1EE``
    gives ``heat_..._kernel<3, 2, true>``); the symbol itself when it is
    not one."""
    m = re.match(r"_Z(\d+)", symbol)
    if m is None:
        return symbol
    start = m.end()
    name = symbol[start:start + int(m.group(1))]
    rest = symbol[start + len(name):]
    if not rest.startswith("I"):
        return name
    args, pos = [], 1
    while True:
        a = _TEMPLATE_ARG.match(rest, pos)
        if a is None:
            break
        kind, value = a.group(1), a.group(2).replace("n", "-")
        args.append(("true" if value == "1" else "false") if kind == "b"
                    else value)
        pos = a.end()
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log: str):
    """Per kernel instance of one nvcc log (``-Xptxas -v``): ``{"instance":
    demangled name, "registers", "spill_stores", "spill_loads",
    "stack_bytes", "smem_bytes"}`` (bytes; smem the static shared
    memory), in the order ptxas reports them."""
    rows, cur = {}, None
    for line in log.splitlines():
        e = _PTXAS_ENTRY.search(line)
        if e is not None:
            cur = rows.setdefault(e.group(1), {"instance": demangle(
                e.group(1))})
            continue
        if cur is None:
            continue
        s = _PTXAS_SPILL.search(line)
        if s is not None:
            cur.update(stack_bytes=int(s.group(1)),
                       spill_stores=int(s.group(2)),
                       spill_loads=int(s.group(3)))
        u = _PTXAS_USED.search(line)
        if u is not None:
            cur.update(registers=int(u.group(1)),
                       smem_bytes=int(u.group(2) or 0))
    return list(rows.values())


class BuildError(RuntimeError):
    """A kernel could not be built or loaded."""


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise BuildError("nvcc not found (on PATH or under "
                         "/usr/local/cuda/bin): the CUDA kernels cannot "
                         "be built on this machine")
    return path


def _entry(name: str):
    """``(source, argtypes)`` of a kernel, a tool's kernel or a helper."""
    for table in (KERNELS, TOOLS):
        if name in table:
            return table[name]
    return HELPERS[name]


def owner(name: str) -> str:
    """The kernel whose library holds entry point ``name`` (itself but for
    :data:`ENTRIES`)."""
    return ENTRIES[name][0] if name in ENTRIES else name


def library_path(name: str) -> Path:
    name = owner(name)
    source, _ = _entry(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source,) + _COMMON:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas's report) of the build of kernel ``name``'s
    current library, from this process or from the file an earlier build
    left beside the library; "" when neither has it."""
    name = owner(name)
    if name in BUILD_LOG:
        return BUILD_LOG[name]
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(*names: str) -> Dict[str, Path]:
    """Build the named kernels (all of :data:`KERNELS` by default; a
    tool's kernel of :data:`TOOLS` or a helper of :data:`HELPERS` by
    name) that are not built yet,
    one nvcc process per source, started together. Returns the library
    path of each name; raises :class:`BuildError` with nvcc's stderr."""
    names = names or tuple(KERNELS)
    paths = {name: library_path(name) for name in names}
    todo = list(dict.fromkeys(owner(name) for name in names
                              if not paths[name].exists()))
    if not todo:
        return paths
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        start = time.perf_counter()
        for name in todo:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / _entry(name)[0])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))

        def finish(name):
            # One thread a process, so that each one's end is timed.
            outs = procs[name][1].communicate(timeout=600)
            BUILD_SECONDS[name] = time.perf_counter() - start
            return outs

        with ThreadPoolExecutor(len(procs)) as pool:
            done = dict(zip(procs, pool.map(finish, procs)))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = done[name]
            BUILD_LOG[name] = out + err
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{err}")
            else:
                path = library_path(name)
                path.with_suffix(".log").write_text(out + err)
                os.replace(tmp, path)
        if failed:
            raise BuildError("\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (of the kernel that holds it,
    for an entry point of :data:`ENTRIES`, with that entry point bound),
    built first if needed."""
    if name in ENTRIES:
        lib = load(owner(name))
        with _lock:
            fn = getattr(lib, name)
            fn.argtypes = ENTRIES[name][1]
            fn.restype = ctypes.c_int
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)[name]
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise BuildError(f"cannot load {path}: {e}") from e
            fn = getattr(lib, name)
            fn.argtypes = _entry(name)[1]
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def main(argv=None) -> int:
    import json
    import sys

    names = tuple(sys.argv[1:] if argv is None else argv)
    for name in names or tuple(KERNELS):
        if not any(name in t for t in (KERNELS, TOOLS, HELPERS, ENTRIES)):
            known = (list(KERNELS) + list(TOOLS) + list(HELPERS)
                     + list(ENTRIES))
            raise SystemExit(f"unknown kernel {name!r}; one of {known}")
    for name, path in build(*names).items():
        rows = ptxas_report(build_log(name))
        print(json.dumps({"kernel": name, "library": path.name,
                          "instances": rows or "no report kept"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

