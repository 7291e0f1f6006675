"""Build and load the hand-written CUDA kernels of ``cl_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
library is built at first use into ``cl_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a checkout
builds everything from its own sources and a changed source rebuilds.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_int64
F = ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream as void*,
# a float as c_float). The packed conv's bf16 entry points take `ew_bf16`
# (CL_TPU_E_BF16's bf16 chains) as the int before the stream.
SIGNATURES = {
    "cltorch_head_ce_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    "cltorch_head_ce_bwd": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    "cltorch_head_ce_bn_fwd": [P] * 16 + [I] * 5 + [F, I, P],
    "cltorch_head_ce_bn_bwd": [P] * 17 + [I] * 5 + [F, I, P],
    "cltorch_head_ce_bn_mma_info": [I, I, P],
    "cltorch_head_ce_bn_fwd_mma_info": [I, I, P],
    "cltorch_head_ce_kd_bn_fwd": [P] * 16 + [I] * 5 + [F, I, P],
    "cltorch_head_ce_kd_bn_bwd": [P] * 17 + [I] * 5 + [F, I, P],
    "cltorch_head_ce_kd_fwd": [P] * 16 + [I] * 5 + [F, I, P],
    "cltorch_head_ce_kd_bwd": [P] * 17 + [I] * 5 + [F, I, P],
    "cltorch_head_ce_pk_fwd": [P] * 16 + [I] * 5 + [F, I, P],
    "cltorch_head_ce_pk_bwd": [P] * 17 + [I] * 5 + [F, I, P],
    "cltorch_ce_fwd": [P, P, P, P, P, I, I, I, I, I, P],
    "cltorch_ce_bwd": [P, P, P, P, P, I, I, I, I, I, P],
    "cltorch_kd_fwd": [P] * 6 + [I] * 4 + [F, I, P],
    "cltorch_kd_bwd": [P] * 6 + [I] * 4 + [F, I, P],
    "cltorch_conv3x3_bn_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    "cltorch_conv3x3_bn_ring": [I] + [P] * 11 + [I] * 12 + [P],
    "cltorch_conv3x3_ring_info": [I, I, I, I, I, P],
    "cltorch_bn_relu_fwd": [P, P, P, P, L, I, I, P],
    "cltorch_add_stats_fwd": [P, P, P, P, P, L, I, I, I, P],
    "cltorch_maxpool_fwd": [P, P, I, I, I, I, I, P],
    "cltorch_upconv_fwd": [P] * 4 + [I] * 9 + [P],
    "cltorch_upconv_fwd_info": [I, I, P],
    "cltorch_bn_relu_bwd": [P, P, P, P, P, P, P, L, I, I, I, P],
    "cltorch_dy_eff": [P, P, P, P, P, L, I, I, P],
    "cltorch_maxpool_bwd": [P, P, P, P, I, I, I, I, I, P],
    "cltorch_upconv_dx": [P, P, P] + [I] * 9 + [P],
    "cltorch_upconv_dx_info": [I, I, P],
    "cltorch_upconv_dw": [P] * 6 + [I] * 9 + [P],
    "cltorch_upconv_dw_ring_info": [I, I, P],
    "cltorch_conv3x3_bn_dx": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    "cltorch_conv3x3_bn_bwd_fused": [P] * 13 + [I] * 7 + [P],
    "cltorch_conv3x3_bn_dw": [P] * 9 + [I] * 11 + [P],
    "cltorch_conv3x3_dw_ring_info": [I, I, P],
    "cltorch_conv3x3_fwd": [P, P, P] + [I] * 10 + [P],
    "cltorch_conv3x3_plain_info": [I] * 5 + [P],
    "cltorch_conv3x3_dw": [P] * 4 + [I] * 9 + [P],
    "cltorch_conv3x3_v3_dw_info": [I, I, I, P],
    "cltorch_conv3x3_dw_bn": [P] * 6 + [I] * 11 + [P],
    "cltorch_conv3x3_dw_bn_info": [I, I, I, P],
    "cltorch_conv3x3_g2_fwd": [P, P, P] + [I] * 10 + [P],
    "cltorch_conv3x3_g2_dw": [P] * 4 + [I] * 9 + [P],
    "cltorch_conv3x3_g2_dw_info": [I, I, I, P],
    "cltorch_conv3x3_bn_quant": [P, P, P] + [I] * 6 + [P],
    "cltorch_conv3x3_bn_dx_q": [P] * 14 + [I] * 13 + [P],
    "cltorch_conv3x3_dx_q_info": [I] * 9 + [P],
    "cltorch_conv3x3_bn_dw_q": [P] * 12 + [I] * 12 + [P],
    "cltorch_conv3x3_dw_q_info": [I] * 5 + [P],
    "cltorch_ewc_penalty": [P, P, P, L, I, P, P, I, P],
    "cltorch_ewc_grad": [P, P, P, P, P, L, I, P],
    "cltorch_ewc_sq_acc": [P, P, L, I, P],
    "cltorch_replay_gather": [P, P, P, L, I, I, I, P],
    "cltorch_augment_image": [P] * 7 + [I] * 3 + [F] * 6 + [I, P],
    "cltorch_augment_mask": [P] * 4 + [I] * 3 + [P],
}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile (if needed) and return the path of the shared library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libcltorch_{source_hash()}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in cus:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", src, "-o", obj]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
                *(obj for _, obj, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    return lib_path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err})")
