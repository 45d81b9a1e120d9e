#!/usr/bin/env python3
"""Where the fused int8 MLP kernel's time goes, by part.

    python3 tools/mlp_breakdown.py

Builds copies of ``givepose_torch/csrc/int8_mlp.cu`` with one part taken
out each (``BREAKDOWN``: the two passes' epilogues, then also both
products' ``wgmma`` instructions, the amax shortcut, the IEEE division of
the requantization, pass 2's activation, the producer warpgroup's register
rebalancing), one nvcc each, all started together, and times each beside
the kernel itself per block of the two ConvNeXt-B int8 stages at batch 32
(LN variant, bf16, L2 flushed before each call, as ``chip_smoke.time_mlp``
times it).  The copies' outputs are wrong by design: only their times
mean anything.  The parts are found as text in the kernel's source; a
part whose text the source no longer holds is reported and left out.  It
needs one NVIDIA GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (text in int8_mlp.cu, what replaces it)
# the two passes' epilogues, then the two products' wgmma instructions
NO_EPILOGUE = [("    if (cb < hd) {\n      float m1a",
                "    if (false) {\n      float m1a"),
               ("      if (cb < hd) {\n        const float2 sc",
                "      if (false) {\n        const float2 sc")]
NO_MMA = [("        wgmma_tile<kH>(acc, desc(a + kk), desc(b + kk));", ""),
          ("            wgmma_tile<kN2>(acc2[a], desc(h_a + kk), "
           "desc(b + kk));", "")]
# pass 1 takes the activation of every value (no amax shortcut)
NO_SHORTCUT = [("    if (m1 >= kActFloor && m2 <= m1 * kNear) "
                "return act_fn<ACT>(m1);", "")]
# pass 2 quantizes by a multiplication instead of the IEEE division, and
# without the activation (both wrong results: what the two steps cost)
PASS2_A = "act_fn<ACT>(pre_act(acc[4 * b + e], xa, se, be))"
PASS2_B = "act_fn<ACT>(pre_act(acc[4 * b + 2 + e], xb, se, be))"
NO_DIVISION = [("// the hidden value before its activation",
                "__device__ __forceinline__ int8_t quantize_mul(float v, "
                "float s) {\n  return static_cast<int8_t>(__float2int_rn("
                "__fmul_rn(v, s)));\n}\n\n"
                "// the hidden value before its activation"),
               ("quantize(\n                    " + PASS2_A,
                "quantize_mul(\n                    " + PASS2_A),
               ("quantize(\n                    " + PASS2_B,
                "quantize_mul(\n                    " + PASS2_B)]
NO_GELU_PASS2 = [(PASS2_A, PASS2_A[len("act_fn<ACT>"):]),
                 (PASS2_B, PASS2_B[len("act_fn<ACT>"):])]
# no register rebalancing: a producer warp and 168 registers a thread
REGS_168 = [("constexpr int kThreads = kConsumers + 128;",
             "constexpr int kThreads = kConsumers + 32;"),
            ("    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 40;\\n\" ::: "
             "\"memory\");\n", ""),
            ("  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 232;\\n\" ::: "
             "\"memory\");\n", "")]
BREAKDOWN = {"kernel": [], "no_epilogue": NO_EPILOGUE,
             "weights_only": NO_EPILOGUE + NO_MMA,
             "no_shortcut": NO_SHORTCUT, "no_division": NO_DIVISION,
             "no_gelu_pass2": NO_GELU_PASS2, "regs_168": REGS_168}


def build_variants(smoke) -> dict:
    """Each variant of ``BREAKDOWN`` whose edits apply, compiled into its
    own library under build/int8_mlp_breakdown/; returns name -> the
    library's ``int8_mlp`` entry point."""
    from givepose_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "int8_mlp_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "int8_mlp.cu")) as f:
        src = f.read()
    t0 = time.time()
    jobs = {}
    for name, edits in BREAKDOWN.items():
        missing = [old for old, _ in edits if old not in src]
        if missing:
            smoke.log(f"  {name}: left out, int8_mlp.cu no longer holds "
                      f"{missing[0].strip()!r}")
            continue
        text = src
        for old, new in edits:
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
               str(_build.CSRC_DIR), "-o", lib, path]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            smoke.log(f"  {name}: left out, nvcc failed:\n{err}")
            continue
        fn = ctypes.CDLL(lib).int8_mlp
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    smoke.log(f"  built {list(fns)} in {time.time() - t0:.1f} s")
    return fns


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("mlp_breakdown: needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from givepose_torch.ops.quant_matmul import ACTS

    card = smoke.card_line()
    smoke.log(card)
    fns = build_variants(smoke)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for stage, blocks, m, c in smoke.MLP_STAGES:
        inp = smoke.mlp_inputs(gen, m, c, torch.bfloat16)
        y, res, w0t, s0, b0, w1t, s1, b1, act, ln = smoke.mlp_operands(
            inp, True)[0]
        ln_ptrs = [ln[0].reshape(m).contiguous(),
                   ln[1].reshape(m).contiguous(), ln[2], ln[3]]
        out = torch.empty_like(y)
        for name, fn in fns.items():
            def call():
                err = fn(y.data_ptr(), res.data_ptr(), out.data_ptr(),
                         w0t.data_ptr(), s0.data_ptr(), b0.data_ptr(),
                         w1t.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                         *[t.data_ptr() for t in ln_ptrs], m, c, 4 * c, 1,
                         ACTS[act], 1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} launch: cudaError {err}")

            ms = smoke.time_ms(call, 20, flush)
            smoke.log(f"  int8_mlp {stage} ({m}, {c}) {name:<13} "
                      f"{ms * 1e3:9.1f} us per block, x {blocks} = "
                      f"{ms * blocks:.3f} ms [{card}]")


if __name__ == "__main__":
    main()
