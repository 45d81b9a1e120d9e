#!/usr/bin/env python3
"""Where the DCNv3 forward and backward kernels' time goes, by part.

    python3 tools/dcnv3_breakdown.py [--csrc DIR] [--reps N]

Builds copies of ``givepose_torch/csrc/dcnv3_fwd.cu`` and
``csrc/dcnv3_bwd.cu`` with one part taken out each (``FWD_PARTS``,
``BWD_PARTS``), one nvcc each, all started together, and times each copy
beside the kernel itself at the three MAPEncoder layers: the forward at
batch 32, the backward at the training batch 48, bf16 x, offsets N(0, 2
px), L2 flushed before each call, as ``chip_smoke.time_layers`` and
``time_bwd_layers`` time them.  The backward's copies are timed on their
C entry point alone, into a d_x filled once; the d_x fill
(``torch.zeros`` of the input's shape in f32) is timed on its own, and
this checkout's wrapper ``dcnv3_bwd_cuda`` (fill and kernel) beside them.
Beside the forward's parts: the forward with a window of 4 (``window4``,
the fast configuration's clamp in the forward's body) and this checkout's
windowed kernel at the same window (``win_fwd_window4``).  Last, this
checkout's backward wrapper at other tiles and vector widths than its
own (``BWD_SWEEP``), the choices ``ops/dcnv3_cuda.py`` makes.

The copies' outputs are wrong by design: only their times mean anything.
Each part is found as text in the kernel's source.  A part lists its edits
for each design the kernel has had (one warp per (pixel, group), then the
tiled design); the first whose text the source holds
is used, and a part that matches none is reported and left out.
``--csrc`` times the sources of another checkout (for example an earlier
commit unpacked with ``git archive``) with this checkout's shared header
``dcnv3_common.cuh`` only if that checkout has none.  It needs one NVIDIA
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# B1, the design with one warp per (pixel, group)
_OLD_FWD_TAP = ("        const Corners k =\n"
                "            tap_corners(p, oh, ow, i, j, off[2 * tap], "
                "off[2 * tap + 1]);")
_OLD_FWD_CONST = ("        Corners k;\n"
                  "        k.x0 = p.stride * ow - p.pad + i * p.dilation;\n"
                  "        k.y0 = p.stride * oh - p.pad + j * p.dilation;\n"
                  "        k.fx = 0.25f; k.fy = 0.75f; k.gx = k.gy = 1.0f;\n"
                  "        k.vx0 = k.x0 >= 0 && k.x0 < p.w;\n"
                  "        k.vx1 = k.x0 + 1 >= 0 && k.x0 + 1 < p.w;\n"
                  "        k.vy0 = k.y0 >= 0 && k.y0 < p.h;\n"
                  "        k.vy1 = k.y0 + 1 >= 0 && k.y0 + 1 < p.h;")
_OLD_FWD_ALL = [("        const int x0 = k.x0, y0 = k.y0;",
                 "        const int x0 = min(max(k.x0, 0), p.w - 2), "
                 "y0 = min(max(k.y0, 0), p.h - 2);")] + [
    (f"          if ({a} && {b}) {{", "          if (true) {")
    for a, b in (("vy0", "vx0"), ("vy0", "vx1"), ("vy1", "vx0"),
                 ("vy1", "vx1"))]
# a stand-in for a corner load: constants, no memory access
_FAKE_LOAD = ("namespace {\n\ntemplate <typename T>\n"
              "__device__ __forceinline__ void fake_load(const T*, float* v, "
              "int vec) {\n  v[0] = 1.0f;\n  if (vec == 2) v[1] = 1.0f;\n}\n")
_OLD_FWD_NO_LOADS = [("namespace {\n", _FAKE_LOAD),
                     ("load_vec(xg + (", "fake_load(xg + (")]

# B2, the design with one warp per (pixel, group)
_OLD_BWD_TAP = ("      const Corners k =\n"
                "          tap_corners(p, oh, ow, i, j, offset[off_base + 2 "
                "* tap],\n"
                "                      offset[off_base + 2 * tap + 1]);")
_OLD_BWD_CONST = _OLD_FWD_CONST.replace("\n        ", "\n      ").replace(
    "        Corners k;", "      Corners k;")
_OLD_BWD_NO_SCATTER = [("                                        float scale) "
                        "{\n  if (VEC == 2) {",
                        "                                        float scale) "
                        "{\n  return;\n  if (VEC == 2) {")]
_OLD_BWD_NO_LOADS = [("namespace {\n", _FAKE_LOAD),
                     ("load_vec(xg + at", "fake_load(xg + at")]
_OLD_BWD_NO_SUMS = [("  for (int o = 16; o > 0; o >>= 1) v += "
                     "__shfl_xor_sync(0xffffffffu, v, o);\n", "")]

# B1 and B2, the tiled design: the taps are computed in the shared
# header's fill_taps (and, backward, again for d_offset and d_mask)
_NEW_TAP = ("    const Corners c = tap_corners(p, oh, ow, tap / p.kernel, "
            "tap % p.kernel,\n"
            "                                  offset[2 * at], "
            "offset[2 * at + 1]);")
_NEW_CONST = ("    Corners c;\n"
              "    c.x0 = p.stride * ow - p.pad + tap / p.kernel * "
              "p.dilation;\n"
              "    c.y0 = p.stride * oh - p.pad + tap % p.kernel * "
              "p.dilation;\n"
              "    c.fx = 0.25f; c.fy = 0.75f; c.gx = c.gy = 1.0f;\n"
              "    c.vx0 = c.x0 >= 0 && c.x0 < p.w;\n"
              "    c.vx1 = c.x0 + 1 >= 0 && c.x0 + 1 < p.w;\n"
              "    c.vy0 = c.y0 >= 0 && c.y0 < p.h;\n"
              "    c.vy1 = c.y0 + 1 >= 0 && c.y0 + 1 < p.h;")
_NEW_BWD_TAP = _NEW_TAP.replace("const Corners c", "const Corners k")
_NEW_BWD_CONST = _NEW_CONST.replace(" c.", " k.").replace(
    "Corners c;", "Corners k;").replace("c.x0", "k.x0").replace(
    "c.y0", "k.y0")
_NEW_FWD_LOAD = ("          load_n<VEC>(xi + tap_safe(e.idx[k]) + c, val, "
                 "tap_valid(e.idx[k]));")
_NEW_BWD_LOAD = "          load_n<VEC>(xi + tap_safe(e.idx[k]) + cc, val, ok);"
_ONES = ("          for (int v = 0; v < VEC; ++v) val[v] = 1.0f;")

# (part, [edits for each design]); "kernel" is the source as it is.  An
# edit applies to the kernel's source or to dcnv3_common.cuh, wherever its
# text is.
FWD_PARTS = {
    "kernel": [[]],
    "const_location": [[(_OLD_FWD_TAP, _OLD_FWD_CONST)],
                       [(_NEW_TAP, _NEW_CONST)]],
    "no_corner_loads": [_OLD_FWD_NO_LOADS, [(_NEW_FWD_LOAD, _ONES)]],
    # the old design's four validity branches; the new one's zeroing select
    "all_corners": [_OLD_FWD_ALL,
                    [(_NEW_FWD_LOAD, _NEW_FWD_LOAD.replace(
                        "tap_valid(e.idx[k])", "true"))]],
    # the forward with a window of 4 (the fast configuration's), to set
    # beside the windowed kernel B3
    "window4": [[("           offset_scale, 0};",
                  "           offset_scale, 4};")]],
}
BWD_PARTS = {
    "kernel": [[]],
    "const_location": [[(_OLD_BWD_TAP, _OLD_BWD_CONST)],
                       [(_NEW_TAP, _NEW_CONST),
                        (_NEW_BWD_TAP, _NEW_BWD_CONST)]],
    "no_corner_loads": [_OLD_BWD_NO_LOADS, [(_NEW_BWD_LOAD, _ONES)]],
    "no_scatter": [_OLD_BWD_NO_SCATTER,
                   [("          if (ok) scatter<VEC>(dxi + tap_safe(e.idx[k])"
                     " + c, add);\n", "")]],
    "no_warp_sums": [_OLD_BWD_NO_SUMS,
                     [("  for (int o = 1; o < seg; o <<= 1) {",
                       "  for (int o = 1; o < 1; o <<= 1) {")]],
}
# (channels a lane, output tile of a block) of the backward to time
BWD_SWEEP = [(4, (2, 4)), (4, (4, 8)), (4, (1, 8)), (4, (2, 2)),
             (4, (1, 1)), (8, (2, 4)), (8, (4, 8))]
HEADER = "dcnv3_common.cuh"
# an entry point with the tile after vec (the tiled design); before it,
# the ints after offset_scale were vec (forward) or window and vec
# (backward), and vec was 2 or 1
TILED = "int tile_h"
UNTILED_TAIL = {"fwd": 1, "bwd": 2}


def variant_sources(files: dict, parts: dict, log) -> dict:
    """part -> {file name: edited text}, for each part one of whose edit
    lists applies in full to ``files`` (the kernel's source and the
    shared header, by name)."""
    out = {}
    for name, designs in parts.items():
        for edits in designs:
            if all(any(old in t for t in files.values()) for old, _ in edits):
                texts = dict(files)
                for old, new in edits:
                    texts = {f: t.replace(old, new) for f, t in texts.items()}
                out[name] = texts
                break
        else:
            log(f"  {name}: left out, the source holds none of its anchors")
    return out


def build_variants(csrc: str, log) -> dict:
    """(kernel, part) -> (source text, loaded library) of each variant
    whose edits apply, built under build/dcnv3_breakdown/."""
    from givepose_torch.ops import _build

    base = os.path.join(ROOT, "build", "dcnv3_breakdown")
    header = os.path.join(csrc, HEADER)
    if not os.path.exists(header):
        header = str(_build.CSRC_DIR / HEADER)
    t0 = time.time()
    jobs = {}
    for kernel, parts in (("fwd", FWD_PARTS), ("bwd", BWD_PARTS)):
        source = f"dcnv3_{kernel}.cu"
        files = {}
        for name, path in ((source, os.path.join(csrc, source)),
                           (HEADER, header)):
            with open(path) as f:
                files[name] = f.read()
        log(f" {source}:")
        for part, texts in variant_sources(files, parts, log).items():
            out_dir = os.path.join(base, f"{kernel}_{part}")
            os.makedirs(out_dir, exist_ok=True)
            for name, text in texts.items():
                with open(os.path.join(out_dir, name), "w") as f:
                    f.write(text)
            lib = os.path.join(out_dir, f"lib{kernel}_{part}.so")
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", out_dir,
                   "-o", lib, os.path.join(out_dir, source)]
            jobs[(kernel, part)] = (texts[source], lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    libs = {}
    for key, (text, lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            log(f"  {key}: left out, nvcc failed:\n{err}")
            continue
        libs[key] = (text, ctypes.CDLL(lib))
    log(f"  built {sorted(libs)} in {time.time() - t0:.1f} s")
    return libs


def entry(text: str, lib, kernel: str, args: tuple):
    """A call of a variant's C entry point, bound as the port's wrapper
    binds the kernel's, with ``args`` (the wrapper's; without the tile
    for an entry point that takes none); raises if the launch fails."""
    from givepose_torch.ops.dcnv3_cuda import _SIGNATURES, _bind

    name = f"dcnv3_{kernel}"
    n_tail = _SIGNATURES[name][1]
    if TILED not in text:
        keep = len(args) - 1 - (n_tail - UNTILED_TAIL[kernel])
        args = list(args[:keep]) + [args[-1]]
        # the untiled kernels move 2 channels a lane where the tiled ones
        # move an even number, else 1
        args[keep - 1] = 2 if args[keep - 1] % 2 == 0 else 1
        n_tail = UNTILED_TAIL[kernel]
    fn = _bind(getattr(lib, name), name, n_tail)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} variant launch: cudaError {err}")
    return call


def sweep_bwd(smoke, card: str, flush, reps: int, totals: dict) -> None:
    """The backward wrapper (fill and kernel) at each of ``BWD_SWEEP``'s
    vector widths and tiles, at the three layers; adds their sums to
    ``totals``."""
    import torch

    from givepose_torch.ops import dcnv3_cuda

    gen = torch.Generator(device="cuda").manual_seed(1)
    kw = dict(kernel=3, stride=2, pad=1, dilation=1, group=4)
    vec, tile = dcnv3_cuda.BWD_VEC, dcnv3_cuda.dcn_tile
    try:
        for name, side in smoke.MAIN_LAYERS:
            x, off, m = smoke.dcnv3_inputs(gen, smoke.TRAIN_BATCH, side, side,
                                           4, 64, 2, 1, 1, 2.0)
            x = x.to(torch.bfloat16)
            g = torch.randn(*off.shape[:3], 256, generator=gen,
                            device="cuda")
            for v, t in BWD_SWEEP:
                dcnv3_cuda.BWD_VEC = v
                dcnv3_cuda.dcn_tile = (
                    lambda group, kernel, backward, t=t:
                    t if backward else tile(group, kernel, backward))
                ms = smoke.time_ms(lambda: dcnv3_cuda.dcnv3_bwd_cuda(
                    x, off, m, g, **kw), reps, flush)
                part = f"vec{v}_tile{t[0]}x{t[1]}"
                totals[("bwd", part)] = totals.get(("bwd", part), 0.0) + ms
                smoke.log(f"  dcnv3_bwd {name} batch {smoke.TRAIN_BATCH} "
                          f"{part:<16} {ms * 1e3:8.1f} us [{card}]")
    finally:
        dcnv3_cuda.BWD_VEC, dcnv3_cuda.dcn_tile = vec, tile


def main(argv: list[str]) -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=None,
                    help="kernel sources to time (default: this checkout's)")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("dcnv3_breakdown: needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from givepose_torch.ops import _build
    from givepose_torch.ops.dcnv3_cuda import (bwd_args, dcnv3_bwd_cuda,
                                               dcnv3_win_cuda, fwd_args)

    csrc = os.path.abspath(args.csrc or str(_build.CSRC_DIR))
    card = smoke.card_line()
    smoke.log(f"{card}\n sources: {csrc}")
    libs = build_variants(csrc, smoke.log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kw = dict(kernel=3, stride=2, pad=1, dilation=1, group=4,
              offset_scale=1.0)
    totals: dict = {}
    for name, side in smoke.MAIN_LAYERS:
        x, off, m = smoke.dcnv3_inputs(gen, smoke.BATCH, side, side, 4, 64,
                                       2, 1, 1, 2.0)
        x = x.to(torch.bfloat16)
        out = torch.empty(*off.shape[:3], 256, device="cuda")
        timed = {"win_fwd_window4": lambda: dcnv3_win_cuda(x, off, m,
                                                           window=4, **kw)}
        for (kernel, part), (text, lib) in sorted(libs.items()):
            if kernel == "fwd":
                timed[part] = entry(text, lib, "fwd",
                                    fwd_args(x, off, m, out, **kw))
        for part, call in timed.items():
            ms = smoke.time_ms(call, args.reps, flush)
            totals[("fwd", part)] = totals.get(("fwd", part), 0.0) + ms
            smoke.log(f"  dcnv3_fwd {name} batch {smoke.BATCH} {part:<16} "
                      f"{ms * 1e3:8.1f} us [{card}]")
        del x, off, m, out
        x, off, m = smoke.dcnv3_inputs(gen, smoke.TRAIN_BATCH, side, side, 4,
                                       64, 2, 1, 1, 2.0)
        x = x.to(torch.bfloat16)
        g = torch.randn(*off.shape[:3], 256, generator=gen, device="cuda")
        d_x = torch.zeros(x.shape, device="cuda")
        d_off, d_m = torch.empty_like(off), torch.empty_like(m)
        timed = {"fill": lambda: torch.zeros(x.shape, device="cuda"),
                 "wrapper": lambda: dcnv3_bwd_cuda(x, off, m, g, **kw)}
        for (kernel, part), (text, lib) in sorted(libs.items()):
            if kernel == "bwd":
                timed[part] = entry(text, lib, "bwd", bwd_args(
                    x, off, m, g, d_x, d_off, d_m, window=0, **kw))
        for part, call in timed.items():
            ms = smoke.time_ms(call, args.reps, flush)
            totals[("bwd", part)] = totals.get(("bwd", part), 0.0) + ms
            smoke.log(f"  dcnv3_bwd {name} batch {smoke.TRAIN_BATCH} "
                      f"{part:<16} {ms * 1e3:8.1f} us [{card}]")
        del x, off, m, g, d_x, d_off, d_m
    sweep_bwd(smoke, card, flush, args.reps, totals)
    for (kernel, part), ms in totals.items():
        smoke.log(f"  dcnv3_{kernel} three layers {part:<16} "
                  f"{ms * 1e3:8.1f} us [{card}]")


if __name__ == "__main__":
    main(sys.argv[1:])
