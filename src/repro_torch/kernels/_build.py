"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` (pointers as ``c_void_p``,
ints as ``c_int``), so no PyTorch header is compiled.  Libraries go to
``src/repro_torch/build/`` (listed in ``.gitignore``), named by a hash of
the source and flags, and are built at first use; :func:`build` starts one
``nvcc`` per source, all at once.  Nothing is built or loaded at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
KERNELS = ("similarity", "predict", "cluster", "select", "rerank", "support",
           "flash_attention", "flash_attention_bwd", "embedding_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_variant_libs: Dict[Path, ctypes.CDLL] = {}   # build_variants' copies
# counters of a dry run (``launch/op_cost.py``'s ``OpCounter``), each
# called as fn(kernel, operations, bytes) by a wrapper given meta tensors
META_LISTENERS: List[Callable[[str, float, float], None]] = []
# run-time compile events (``analysis/retrace.py``'s sentinel), each
# called as fn(event, name): "build" when an ``nvcc`` run for
# ``csrc/<name>.cu`` ends, "load" when this process first opens its library
COMPILE_LISTENERS: List[Callable[[str, str], None]] = []


def meta_call(name: str, work) -> None:
    """A wrapper's call on meta tensors: hand ``work`` (its kernel module's
    ``(operations, bytes)``) to every listening counter; nothing is built,
    loaded or launched, and no launch is counted."""
    ops, n_bytes = work
    for listener in list(META_LISTENERS):
        listener(name, float(ops), float(n_bytes))


def _compile_event(event: str, name: str) -> None:
    for listener in list(COMPILE_LISTENERS):
        listener(event, name)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built")
    return found


def library_path(name: str) -> Path:
    """Content-addressed library path for ``csrc/<name>.cu`` (the hash
    covers the shared ``csrc/*.cuh`` headers too)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library among ``names`` in parallel; returns
    the wall seconds of each compile (0.0 for one already built).  The
    ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside each library as ``<name>-<hash>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, float] = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib, tmp, time.perf_counter())
    errors = []
    for name, (proc, lib, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        _compile_event("build", name)
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed (thread-safe; one build and one load per process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            _compile_event("load", name)
        return lib


def entry_name(mangled: str) -> str:
    """A mangled entry function's name with its template arguments, e.g.
    ``predict_int8_kernelILb1E`` (the namespaces dropped)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group(0)
        start = pos + len(digits)
        pos = start + int(digits)
        name = mangled[start:pos]
    args = re.match(r"I\w*?E(?=E)", mangled[pos:])
    return name + (args.group(0) if args else "")


def ptxas_report(log: str) -> list:
    """(entry function with its template arguments, registers, bytes of
    spill stores) for each entry function of an ``nvcc -Xptxas -v``
    report."""
    out, fn, spill = [], "?", -1
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = entry_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((fn, int(m.group(1)), spill))
    return out


def source_constant(name: str, constant: str) -> int:
    """The value of ``constexpr int <constant> = <value>;`` in
    ``csrc/<name>.cu`` (read from the source: nothing is built), so that a
    launch plan chosen in Python and the kernel share one definition."""
    text = (CSRC / f"{name}.cu").read_text()
    found = re.search(rf"constexpr int {constant} = (\d+);", text)
    if found is None:
        raise LookupError(f"no constexpr int {constant} in {name}.cu")
    return int(found.group(1))


def padded_rows(x, width: int):
    """2-D ``x`` as rows of ``width`` elements at a 16-byte aligned
    address, for kernels that stage rows in 16-byte copies: zero-padded
    on the right (a copy) when narrower, copied when misaligned, else
    ``x`` itself.  Each caller states why its zeros change nothing."""
    if x.shape[1] != width:
        out = x.new_zeros((x.shape[0], width))
        out[:, :x.shape[1]] = x
        return out
    return x if x.data_ptr() % 16 == 0 else x.clone()


def build_variants(variants: Dict[str, tuple]) -> Dict[str, Path]:
    """Patched copies of kernel sources, for timing an earlier or another
    design beside the shipped one (measurement only: no model path loads
    them).  ``variants`` maps a label to ``(name, [(old, new), ...])``,
    each ``old`` found exactly once in ``csrc/<name>.cu``; every copy is
    compiled in parallel into ``build/variants/`` with the shipped flags.
    Returns label → library path, ``-Xptxas -v``'s report beside each
    library as ``<label>.log``."""
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (name, pairs) in variants.items():
        src = (CSRC / f"{name}.cu").read_text()
        for old, new in pairs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {label!r}: {old[:60]!r} occurs "
                                   f"{src.count(old)} times in {name}.cu")
            src = src.replace(old, new)
        stem = re.sub(r"\W+", "_", label)
        cu = out_dir / f"{stem}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        procs[label] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out, errors = {}, []
    for label, (proc, so) in procs.items():
        log = proc.communicate()[0]
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for variant {label!r}:\n{log}")
        out[label] = so
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@contextlib.contextmanager
def swapped(name: str, path: Path):
    """Within the block, ``csrc/<name>.cu``'s wrapper launches the library
    at ``path`` (a :func:`build_variants` copy, opened once a process) in
    place of the shipped one; the shipped library is back after it."""
    with _lock:
        lib = _variant_libs.get(path)
        if lib is None:
            lib = _variant_libs[path] = ctypes.CDLL(str(path))
        before = _libs.get(name)
        _libs[name] = lib
    try:
        yield lib
    finally:
        with _lock:
            if before is None:
                _libs.pop(name, None)
            else:
                _libs[name] = before


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
