#!/usr/bin/env python3
"""Where the W8A8 dense kernels' time goes, by part.

    python3 tools/qmm_breakdown.py [--csrc DIR] [--reps N]

Builds copies of ``givepose_torch/csrc/int8_qmm.cu`` with one part taken
out each (``PARTS``: the per-row amax pass of B4, its quantization of x
(a constant int8 instead), the int8 products, the GELU of the epilogue,
the output stores), one nvcc each, all started together, and times each
copy beside the kernel itself, B4 (``int8_qmm``) and B5
(``int8_qmm_pre``), at the four batch-32 ConvNeXt-B MLP matmuls
(``chip_smoke.QMM_SHAPES``: x and out in bf16, each layer's activation,
L2 flushed before each call, as ``chip_smoke.time_qmm`` times them).
Beside them, on the same operands: bf16 ``F.linear`` (+ GELU) and
``torch._int_mm``, and the host time of one call of each entry point (no
synchronisation inside the timed calls, median of several runs).  Last,
the same checkout's fused int8 MLP (``int8_mlp.cu``, which shares the
Hopper header) per batch-32 fast forward, as ``chip_smoke.time_mlp``
times it, so that two checkouts' B6 can be set side by side.

The copies' outputs are wrong by design: only their times mean anything.
Each part is found as text in the kernel's source.  A part lists its edits
for each design the kernel has had (``mma.sync`` blocks with vector-load
flags, then ``wgmma`` with a TMA operand ring); the first whose text the
source holds is used, and a part that matches none is reported and left
out.  ``--csrc`` times the sources of another checkout (for example an
earlier commit unpacked with ``git archive`` into the ignored ``build/``),
with that checkout's headers.  It needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "int8_qmm.cu"

# the design with mma.sync blocks (one tile per block, vector-load flags)
_OLD_AMAX = ("      const float amax = r < m ? row_amax(x + r * k, k, lane, "
             "vec_x) : 0.0f;")
_OLD_QUANT = "        q = quantize16(x + r * k, r < m, k0 + c, k, xs[i], vec_x);"
_OLD_MMA = ("        mma_s8(acc[mt][j], a[mt][0].x, a[mt][1].x, a[mt][0].y, "
            "a[mt][1].y,\n               w.x, w.y);\n"
            "        mma_s8(acc[mt][j], a[mt][0].z, a[mt][1].z, a[mt][0].w, "
            "a[mt][1].w,\n               w.z, w.w);\n")
_OLD_GELU = "          y[e] = PRE ? act_pre<ACT>(bf(v)) : act_fn<ACT>(v);"
_OLD_STORE = "        TO* o = out + r * n + col;"
_ONES = "make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u)"

# the wgmma design (persistent blocks, TMA operand ring)
_NEW_AMAX = "        const float amax = row < m ? row_amax(xr, k, lane) : 0.0f;"
_NEW_QUANT = "    const uint4 q = quantize16(v, xs_s[r]);"
_NEW_MMA = "          wgmma_tile<WN>(acc, desc(a + kk), desc(b + kk));"
_NEW_GELU = "  return PRE ? act_pre<ACT>(bf(v)) : act_fn<ACT>(v);"
_NEW_STORE = "  const long long o = r * n + c0;"

# part -> one edit list per design; the first that applies is used
PARTS = {
    "kernel": [[]],
    "no_amax": [[(_OLD_AMAX, "      const float amax = 1.0f;")],
                [(_NEW_AMAX, "        const float amax = 1.0f;")]],
    "const_quant": [[(_OLD_QUANT, f"        q = {_ONES};")],
                    [(_NEW_QUANT, f"    const uint4 q = {_ONES};")]],
    "no_products": [[(_OLD_MMA, "")], [(_NEW_MMA, "")]],
    "no_gelu": [[(_OLD_GELU, "          y[e] = PRE ? bf(v) : v;")],
                [(_NEW_GELU, "  return PRE ? bf(v) : v;")]],
    "no_stores": [[(_OLD_STORE, "        if (y[0] != -1234.5f) continue;\n"
                    + _OLD_STORE)],
                  [(_NEW_STORE, "  if (y[0][0] != -1234.5f) return;\n"
                    + _NEW_STORE)]],
}


def variant_sources(text: str, log) -> dict:
    """part -> edited source, for each part one of whose edit lists
    applies in full to ``text``."""
    out = {}
    for name, designs in PARTS.items():
        for edits in designs:
            if all(old in text for old, _ in edits):
                edited = text
                for old, new in edits:
                    edited = edited.replace(old, new)
                out[name] = edited
                break
        else:
            log(f"  {name}: left out, the source holds none of its anchors")
    return out


def build_variants(csrc: str, log) -> dict:
    """part -> (source text, loaded library) of each variant that builds,
    under build/qmm_breakdown/ (the checkout's headers copied beside)."""
    from givepose_torch.ops import _build

    base = os.path.join(ROOT, "build", "qmm_breakdown")
    with open(os.path.join(csrc, SOURCE)) as f:
        text = f.read()
    t0 = time.time()
    jobs = {}
    for part, edited in variant_sources(text, log).items():
        out_dir = os.path.join(base, part)
        os.makedirs(out_dir, exist_ok=True)
        for header in glob.glob(os.path.join(csrc, "*.cuh")):
            shutil.copy(header, out_dir)
        path = os.path.join(out_dir, SOURCE)
        with open(path, "w") as f:
            f.write(edited)
        lib = os.path.join(out_dir, f"lib{part}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", out_dir, "-o",
               lib, path]
        jobs[part] = (edited, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    mlp_dir = os.path.join(base, "int8_mlp")
    os.makedirs(mlp_dir, exist_ok=True)
    mlp_lib = os.path.join(mlp_dir, "libint8_mlp.so")
    mlp_job = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", mlp_lib,
         os.path.join(csrc, "int8_mlp.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    libs = {}
    _, err = mlp_job.communicate()
    if mlp_job.returncode == 0:
        libs["int8_mlp"] = ("", ctypes.CDLL(mlp_lib))
    else:
        log(f"  int8_mlp.cu: left out, nvcc failed:\n{err}")
    for part, (edited, lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            log(f"  {part}: left out, nvcc failed:\n{err}")
            continue
        libs[part] = (edited, ctypes.CDLL(lib))
    log(f"  built {sorted(libs)} in {time.time() - t0:.1f} s")
    return libs


def entry(text: str, lib, name: str, op: dict, act: str, out):
    """A call of a variant's entry point ``name`` (int8_qmm or
    int8_qmm_pre) on the operands ``op`` (``chip_smoke.qmm_operands``),
    bound as its design's wrapper binds it; raises if a launch fails."""
    import torch

    from givepose_torch.ops import quant_matmul as qm

    pre = name == "int8_qmm_pre"
    stream = torch.cuda.current_stream().cuda_stream
    m, k = op["x"].shape
    n = op["wt"].shape[0]
    if "int flags" in text:
        # mma.sync design: vector-load flags (x: 1, wt and xq: 2)
        fn = getattr(lib, name)
        if pre:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            args = (op["xq"].data_ptr(), op["xs"].data_ptr(),
                    op["wt"].data_ptr(), op["ws"].data_ptr(),
                    op["b"].data_ptr(), out.data_ptr(), 1, m, n, k,
                    qm.ACTS[act], 2, stream)
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
                ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            args = (op["x"].data_ptr(), 1, op["wt"].data_ptr(),
                    op["ws"].data_ptr(), op["b"].data_ptr(), out.data_ptr(),
                    1, m, n, k, qm.ACTS[act], 3, stream)
        fn.restype = ctypes.c_int
    else:
        fn = qm.bind_qmm(getattr(lib, name), pre)
        x = op["xq"] if pre else op["x"]
        args = qm.qmm_call_args(x, op["xs"] if pre else None, op["wt"],
                                op["ws"], op["b"], out, act, pre)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} variant launch: cudaError {err}")
    return call


def host_us(call, calls: int = 30, rounds: int = 7) -> float:
    """Median host time of one call, ``calls`` calls issued with no
    synchronisation inside, over ``rounds`` runs."""
    import torch

    runs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            call()
        runs.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def time_mlp(smoke, lib, gen, flush, reps: int, card: str) -> None:
    """The fused int8 MLP of ``lib`` per block of each int8 stage at batch
    32 (LN variant, bf16), summed per fast forward over 27 + 3 blocks."""
    import torch

    from givepose_torch.ops.quant_matmul import ACTS

    fn = lib.int8_mlp
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    total = 0.0
    for stage, blocks, m, c in smoke.MLP_STAGES:
        inp = smoke.mlp_inputs(gen, m, c, torch.bfloat16)
        y, res, w0t, s0, b0, w1t, s1, b1, act, ln = smoke.mlp_operands(
            inp, True)[0]
        ptrs = [t.data_ptr() for t in (
            y, res, torch.empty_like(y), w0t, s0, b0, w1t, s1, b1,
            ln[0].reshape(m).contiguous(), ln[1].reshape(m).contiguous(),
            ln[2], ln[3])]

        def call():
            err = fn(*ptrs, m, c, 4 * c, 1, ACTS[act], 1,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"int8_mlp launch: cudaError {err}")

        ms = smoke.time_ms(call, reps, flush)
        total += blocks * ms
        smoke.log(f"  int8_mlp {stage} ({m}, {c}) bf16 + LN {ms * 1e3:8.1f} "
                  f"us per block [{card}]")
    smoke.log(f"  int8_mlp per fast forward (27 + 3 blocks) "
              f"{total * 1e3:8.1f} us [{card}]")


def main(argv: list[str]) -> None:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=None,
                    help="kernel sources to time (default: this checkout's)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("qmm_breakdown: needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from givepose_torch.ops import _build

    csrc = os.path.abspath(args.csrc or str(_build.CSRC_DIR))
    card = smoke.card_line()
    smoke.log(f"{card}\n sources: {csrc}")
    libs = build_variants(csrc, smoke.log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    bf16 = torch.bfloat16
    totals: dict = {}

    def add(key, ms):
        totals[key] = totals.get(key, 0.0) + ms

    mlp = libs.pop("int8_mlp", (None, None))[1]
    if mlp is not None:
        time_mlp(smoke, mlp, gen, flush, args.reps, card)

    for shape, m, k, n, act in smoke.QMM_SHAPES:
        op = smoke.qmm_operands(gen, m, k, n, bf16)
        out = torch.empty(m, n, dtype=bf16, device="cuda")
        w16 = (op["wq"].float() * op["ws"]).t().contiguous().to(bf16)
        b16 = op["b"].to(bf16)

        def linear():
            y = F.linear(op["x"], w16, b16)
            return F.gelu(y, approximate="tanh") if act != "none" else y

        timed = {("yardstick", "bf16_linear"): linear,
                 ("yardstick", "int_mm"): lambda: torch._int_mm(
                     op["xq"], op["wt"].t())}
        for part, (text, lib) in sorted(libs.items()):
            for name in ("int8_qmm", "int8_qmm_pre"):
                timed[(name, part)] = entry(text, lib, name, op, act, out)
        for (name, part), call in timed.items():
            ms = smoke.time_ms(call, args.reps, flush)
            add((name, part), ms)
            smoke.log(f"  {name} {shape} ({m}, {k} -> {n}) {act:<9} "
                      f"{part:<12} {ms * 1e3:8.1f} us [{card}]")
        for name in ("int8_qmm", "int8_qmm_pre"):
            if "kernel" in libs:
                us = host_us(timed[(name, "kernel")])
                add((name, "host_us_per_call"), us / 4e3)
                smoke.log(f"  {name} {shape} host time per call {us:.2f} us "
                          f"[{card}]")
        del op, out, w16, b16
    for (name, part), ms in totals.items():
        if part == "host_us_per_call":
            smoke.log(f"  {name} mean host time per call {ms * 1e3:.2f} us "
                      f"[{card}]")
        else:
            smoke.log(f"  {name} four batch-32 matmuls {part:<12} "
                      f"{ms * 1e3:8.1f} us [{card}]")


if __name__ == "__main__":
    main(sys.argv[1:])
