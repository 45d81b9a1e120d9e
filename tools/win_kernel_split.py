#!/usr/bin/env python3
"""Where the windowed DCNv3 forward's time goes, by part and by plan.

    python3 tools/win_kernel_split.py [batch] [channels] [variants,...]
                                      [--layers] [--csrc DIR] [--reps N]

The H100 counterpart of ``benchmarks/bench_win_kernel_split.py``, the
TPU sweep of that kernel's design variants.  Defaults as there: batch
128, 256 channels in 4 groups, the first MAPEncoder layer (64 x 64 input
to 32 x 32 output, stride 2, window 4), offsets N(0, 2 px), a softmaxed
mask, bf16 x.  ``--layers`` also runs the three MAPEncoder layers at
batch 32 and sums each variant over them.  ``--csrc DIR`` builds DIR's
``dcnv3_win_fwd.cu`` (with DIR's headers) and times it beside every row,
for example the parent commit unpacked with ``git archive`` into the
ignored ``build/``; without it, the column holds this checkout's kernel.

Each variant of the TPU sweep and its counterpart here:

  mono          (``_mono_kernel``: every row tile of one image in one grid
                step) the kernel with the plan ``win_plan(..., "mono")``:
                one block per (image, group) walking all of its tiles;
                real outputs.
  chunkN        (``_chunk_kernel``: N row tiles a grid step) the plan
                ``win_plan(..., "chunkN")``: N tiles a block; real outputs.
  full          (``_kernel``) the kernel as it is, at its default plan.
  base          (the shell: slab load and store only) a copy of the source
                that stages the slab and stores one slab value per output:
                no taps.
  base_noload   (no load) the same without staging.
  base_half     (half the slab) half of the slab staged.
  base_ylo0     (a static slab origin) ``base`` with the origin at (0, 0).
  ylo0          (the dynamic origin's cost) the kernel with the slab
                origin fixed at (0, 0).
  const_ext     (the x-weight build removed) taps at a constant location:
                no location or weight arithmetic.
  no_mm         (stage A's matmul removed) no corner gathers: constants in
                place of the loads.
  no_stageB     (the y-interpolation removed) only the top row's two
                corners gathered.
  fused         (``fused1``, ``fused2``: the two stages fused) taps
                computed by the gathering warp and broadcast by shuffles,
                with no shared tap table: the kernel's earlier design,
                timed from ``--csrc`` (the parent's column).
  *_bf16        (bf16 weight builds) the corner sums in bf16x2 (HFMA2) at
                the plan of the prefix (``full_bf16``, ``mono_bf16``,
                ``chunk2_bf16``): timed, with the error against the plain
                version printed and not held.
  prep_only     (the XLA prep) a device copy of x, offset and mask: the
                bytes' floor on this card.
  verify        holds ``mono`` and each ``chunkN`` (and the kernel at its
                default plan) against the plain ``dcnv3_core(...,
                window=4)`` on the first images of the batch, within
                ``chip_smoke.KERNEL_BAR`` * max|ref|; exits non-zero if
                one disagrees.

Beside every row: the kernel from ``--csrc`` (the parent's), B1's tiled
body with the same window (``tools/dcnv3_breakdown.py``'s ``window4``
edit of ``dcnv3_fwd.cu``), the bound (x, offset and mask read once, out
written once, at 3.35 TB/s) and the card's name and power limit.  The
kernel, the parent's and B1's are timed before the other rows and again
after them (the two numbers are printed), so that they are compared in
turns.  Times are CUDA events around each call with L2 flushed before it
(``chip_smoke.time_ms``).

The copies' outputs are wrong by design: only their times mean anything.
Each part is found as text in the kernel's source; a part lists its edits
for each design the kernel has had (a warp per output pixel with taps
broadcast by shuffles, then the window's slab staged by TMA with a shared
tap table); the first whose text the source holds is used, and a part
that matches none is reported and left out.  It needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import dcnv3_breakdown  # noqa: E402  (the tiled forward's edits)
SOURCE = "dcnv3_win_fwd.cu"
B1_SOURCE = "dcnv3_fwd.cu"
GROUP = 4
WINDOW = 4
OFFSET_STD = 2.0
# the first images of the batch that ``verify`` holds against the plain
# version (the plain version's memory grows with the batch)
VERIFY_IMAGES = 8

# ---- the design with a warp per output pixel (taps broadcast by shuffles)

_OLD_TAP_LOOP = "      for (int tap = 0; tap < taps; ++tap) {"
_OLD_STORE = "      if (active) {\n        if (VEC == 2) {"
# no taps; one slab value per output
_OLD_BASE = [(_OLD_TAP_LOOP, "      for (int tap = 0; tap < 0; ++tap) {"),
             (_OLD_STORE,
              "      if (active) {\n        float v_[2];\n"
              "        load_vec(slab + c, v_, 1);\n        acc[0] += v_[0];\n"
              "      }\n" + _OLD_STORE)]
_OLD_NOLOAD = [("  for (int i = threadIdx.x; i < cells * units; "
                "i += kThreads) {",
                "  for (int i = threadIdx.x; i < 0; i += kThreads) {")]
_OLD_HALF = [("  const int cells = tile.rows * tile.cols;",
              "  const int cells = tile.rows * tile.cols / 2;")]
_OLD_YLO0 = [("  const int y_org = half + p.stride * oh0 - p.window - p.pad;\n"
              "  const int x_org = half + p.stride * ow0 - p.window - p.pad;",
              "  const int y_org = 0;\n  const int x_org = 0;")]
_OLD_CONST = [("      const Corners k = tap_corners(p, oh, ow, lane / "
               "p.kernel,\n"
               "                                    lane % p.kernel, "
               "off[2 * lane],\n"
               "                                    off[2 * lane + 1]);",
               "      Corners k;\n"
               "      k.x0 = p.stride * ow - p.pad + lane / p.kernel * "
               "p.dilation;\n"
               "      k.y0 = p.stride * oh - p.pad + lane % p.kernel * "
               "p.dilation;\n"
               "      k.fx = 0.25f; k.fy = 0.75f; k.gx = k.gy = 1.0f;\n"
               "      k.vx0 = k.x0 >= 0 && k.x0 < p.w;\n"
               "      k.vx1 = k.x0 + 1 >= 0 && k.x0 + 1 < p.w;\n"
               "      k.vy0 = k.y0 >= 0 && k.y0 < p.h;\n"
               "      k.vy1 = k.y0 + 1 >= 0 && k.y0 + 1 < p.h;")]
# a stand-in for a corner load: constants, no memory access
_FAKE_LOAD = ("namespace {\n\ntemplate <typename T>\n"
              "__device__ __forceinline__ void fake_load(const T*, float* v, "
              "int vec) {\n  v[0] = 1.0f;\n  if (vec == 2) v[1] = 1.0f;\n}\n")
_OLD_NO_LOADS = [("namespace {\n", _FAKE_LOAD),
                 ("load_vec(row0, val, VEC);", "fake_load(row0, val, VEC);"),
                 ("load_vec(row0 + p.gc, val, VEC);",
                  "fake_load(row0 + p.gc, val, VEC);"),
                 ("load_vec(row1, val, VEC);", "fake_load(row1, val, VEC);"),
                 ("load_vec(row1 + p.gc, val, VEC);",
                  "fake_load(row1 + p.gc, val, VEC);")]
_OLD_TOP_ROW = [("          if (iy1 && ix0) {", "          if (false) {"),
                ("          if (iy1 && ix1) {", "          if (false) {")]

# ---- the slab design (TMA-staged slab, shared tap table) ----------------

_NEW_BASE = [("      for (int tap = 0; tap < (KK > 0 ? KK : K); ++tap)\n"
              "        add_tap<T, VEC>(slab, t[tap], c, p.gc, plan.cols * p.gc, "
              "acc);",
              "      {\n        float v_[VEC];\n"
              "        load_n<VEC>(slab + c, v_, true);\n"
              "        acc[0] += v_[0];\n      }"),
             ("store_taps(p, plan, tile(", "if (false) store_taps(p, plan, "
              "tile(")]
_NEW_NOLOAD = [("  mbar_expect_tx(bar, plan.box_bytes);\n  tma_load_4d(",
                "  mbar_expect_tx(bar, 0);\n  if (false) tma_load_4d(")]
_NEW_HALF = [("                             static_cast<cuuint32_t>(plan.cols),",
              "                             static_cast<cuuint32_t>(plan.cols "
              "/ 2),"),
             ("  plan->box_bytes = plan->rows * plan->cols * p.gc * "
              "static_cast<int>(elem);",
              "  plan->box_bytes = plan->rows * (plan->cols / 2) * p.gc * "
              "static_cast<int>(elem);")]
_NEW_YLO0 = [("  return make_int2(half + p.stride * ow0 - p.window - p.pad,\n"
              "                   half + p.stride * oh0 - p.window - p.pad);",
              "  return make_int2(0 * half, 0);")]
_NEW_ADD_TAP = "  const T* at = slab + e.base + c;\n"
# the corner sums in bf16x2 (HFMA2), each tap's sum added to f32
_NEW_BF16 = [(_NEW_ADD_TAP, _NEW_ADD_TAP + """\
  if constexpr (sizeof(T) == 2 && VEC == 8) {
    __nv_bfloat162 s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          at + (k >> 1) * dy + (k & 1) * dx);
      const unsigned wd[4] = {u.x, u.y, u.z, u.w};
      const __nv_bfloat162 w2 = __float2bfloat162_rn(w[k]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v2 =
            *reinterpret_cast<const __nv_bfloat162*>(&wd[i]);
        s[i] = k == 0 ? __hmul2(v2, w2) : __hfma2(v2, w2, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(s[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
    return;
  }
""")]

NEW = {
    "base": [_NEW_BASE],
    "base_noload": [_NEW_BASE + _NEW_NOLOAD],
    "base_half": [_NEW_BASE + _NEW_HALF],
    "base_ylo0": [_NEW_BASE + _NEW_YLO0],
    "ylo0": [_NEW_YLO0],
    "const_ext": [[(
        "  const Corners c = tap_corners(p, oh, ow, tap / p.kernel, tap % "
        "p.kernel,\n                                off_x, off_y);",
        dcnv3_breakdown._NEW_CONST.replace("\n    ", "\n  ").replace(
            "    Corners c;", "  Corners c;"))]],
    "no_mm": [[("    load_n<VEC>(at + (k >> 1) * dy + (k & 1) * dx, val, "
                "true);",
                "#pragma unroll\n    for (int v = 0; v < VEC; ++v) "
                "val[v] = 1.0f;")]],
    "no_stageB": [[("  for (int k = 0; k < 4; ++k) {\n    float val[VEC];",
                    "  for (int k = 0; k < 2; ++k) {\n    float val[VEC];")]],
    "bf16": [_NEW_BF16],
}

# (part, [edits for each design]); "full" is the source as it is.  An
# edit applies to the kernel's source or to a header, wherever its text is.
# The slab design's edits come first.
PARTS = {
    "full": [[]],
    "base": NEW["base"] + [_OLD_BASE],
    "base_noload": NEW["base_noload"] + [_OLD_BASE + _OLD_NOLOAD],
    "base_half": NEW["base_half"] + [_OLD_BASE + _OLD_HALF],
    "base_ylo0": NEW["base_ylo0"] + [_OLD_BASE + _OLD_YLO0],
    "ylo0": NEW["ylo0"] + [_OLD_YLO0],
    "const_ext": NEW["const_ext"] + [_OLD_CONST],
    "no_mm": NEW["no_mm"] + [_OLD_NO_LOADS],
    "no_stageB": NEW["no_stageB"] + [_OLD_TOP_ROW],
    "bf16": NEW["bf16"],
}
# the variants a run takes when none are named
DEFAULT_VARIANTS = ("verify,prep_only,full,fused,mono,chunk2,chunk4,base,"
                    "base_noload,base_half,base_ylo0,ylo0,const_ext,no_mm,"
                    "no_stageB,full_bf16,mono_bf16,chunk2_bf16")
# an entry point that takes a plan (the slab design); before it, the ints
# after offset_scale were window and vec, and vec was 2 or 1
PLANNED = "int tiles_per_block"
UNPLANNED_TAIL = 2


def split_variant(v: str) -> tuple[str, str]:
    """A variant's (part of the source, plan): ``mono_bf16`` ->
    ("bf16", "mono"), ``chunk2`` -> ("full", "chunk2"), ``base`` ->
    ("base", "default")."""
    if v in ("fused1", "fused2"):
        v = "fused"
    if v.endswith("_bf16"):
        plan = v[:-len("_bf16")]
        return "bf16", "default" if plan == "full" else plan
    if v == "mono" or v.startswith("chunk"):
        return "full", v
    return v, "default"


def variant_sources(files: dict, parts, log) -> dict:
    """part -> {file name: edited text}, for each of ``parts`` one of
    whose edit lists applies in full to ``files`` (the kernel's source
    and the headers, by name)."""
    out = {}
    for name in parts:
        for edits in PARTS[name]:
            if all(any(old in t for t in files.values()) for old, _ in edits):
                texts = dict(files)
                for old, new in edits:
                    texts = {f: t.replace(old, new) for f, t in texts.items()}
                out[name] = texts
                break
        else:
            log(f"  {name}: left out, the source holds none of its anchors")
    return out


def read_sources(csrc: str, source: str) -> dict:
    """{file name: text} of ``source`` and every header in ``csrc``."""
    files = {}
    for path in [os.path.join(csrc, source)] + sorted(
            glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path) as f:
            files[os.path.basename(path)] = f.read()
    return files


def start_build(texts: dict, source: str, out_dir: str):
    """nvcc of ``texts[source]`` with its headers into ``out_dir``,
    started; returns (library path, process)."""
    from givepose_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    for name, text in texts.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    lib = os.path.join(out_dir, f"lib{os.path.basename(out_dir)}.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", out_dir, "-o", lib,
           os.path.join(out_dir, source)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def build_all(parts, csrc: str | None, log) -> dict:
    """name -> (source text, loaded library): this checkout's windowed
    kernel for each of ``parts`` whose edits apply, ``parent`` (the
    kernel of ``csrc``, or this checkout's), and ``b1_window4`` (B1 with
    the window), one nvcc each, all started together, under
    build/win_kernel_split/."""
    from givepose_torch.ops import _build

    base = os.path.join(ROOT, "build", "win_kernel_split")
    t0 = time.time()
    here = str(_build.CSRC_DIR)
    files = read_sources(here, SOURCE)
    log(f" {SOURCE} ({here}):")
    jobs = {}
    for part, texts in variant_sources(files, parts, log).items():
        jobs[part] = (texts[SOURCE], SOURCE,
                      *start_build(texts, SOURCE, os.path.join(base, part)))
    parent = read_sources(os.path.abspath(csrc or here), SOURCE)
    jobs["parent"] = (parent[SOURCE], SOURCE,
                      *start_build(parent, SOURCE,
                                   os.path.join(base, "parent")))
    b1 = dcnv3_breakdown.variant_sources(
        read_sources(here, B1_SOURCE),
        {"window4": dcnv3_breakdown.FWD_PARTS["window4"]}, log)
    for texts in b1.values():
        jobs["b1_window4"] = (texts[B1_SOURCE], B1_SOURCE, *start_build(
            texts, B1_SOURCE, os.path.join(base, "b1_window4")))
    libs = {}
    for name, (text, _, lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            log(f"  {name}: left out, nvcc failed:\n{err}")
            continue
        libs[name] = (text, ctypes.CDLL(lib))
    log(f"  built {sorted(libs)} in {time.time() - t0:.1f} s")
    return libs


def win_call(text: str, lib, x, off, m, out, kw: dict, plan: str):
    """A call of a windowed kernel's C entry point (this checkout's
    wrapper's arguments at ``plan``, or, for an entry point without a
    plan, the earlier design's window and vec); raises if the launch
    fails, or if the source takes no plan and ``plan`` is not the
    default."""
    import torch

    from givepose_torch.ops import dcnv3_cuda

    name = "dcnv3_win_fwd"
    if PLANNED in text:
        args = dcnv3_cuda.win_args(x, off, m, out, plan=plan, **kw)
        fn = dcnv3_cuda._bind(getattr(lib, name), name)
    else:
        if plan != "default":
            raise LookupError("the entry point takes no plan")
        n, h, w, c_total = x.shape
        gc = c_total // kw["group"]
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), int(x.dtype == torch.bfloat16),
                off.data_ptr(), m.data_ptr(), out.data_ptr(), n, h, w,
                off.shape[1], off.shape[2], kw["group"], gc, kw["kernel"],
                kw["stride"], kw["pad"], kw["dilation"],
                float(kw["offset_scale"]), kw["window"],
                2 if gc % 2 == 0 else 1, stream)
        fn = dcnv3_cuda._bind(getattr(lib, name), name, UNPLANNED_TAIL)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} variant launch: cudaError {err}")
    return call


def b1_call(text: str, lib, x, off, m, out, kw: dict):
    """B1 with the window: this checkout's forward arguments."""
    from givepose_torch.ops.dcnv3_cuda import fwd_args

    fwd_kw = {k: v for k, v in kw.items() if k != "window"}
    return dcnv3_breakdown.entry(text, lib, "fwd",
                                 fwd_args(x, off, m, out, **fwd_kw))


def shapes(batch: int, channels: int, layers: bool, smoke) -> list:
    """(label, batch, input side, gc): B7's shape, then with ``layers``
    the three MAPEncoder layers at batch 32."""
    out = [(f"b7 batch {batch} layer0", batch, 64, channels // GROUP)]
    if layers:
        out += [(f"{name} batch {smoke.BATCH}", smoke.BATCH, side, 64)
                for name, side in smoke.MAIN_LAYERS]
    return out


def run_shape(label, n, side, gc, variants, libs, smoke, card, flush,
              reps, totals, failures) -> None:
    """Time (and for ``verify`` check) every variant at one shape; add
    each time to ``totals[variant]``."""
    import torch

    from givepose_torch.ops.dcnv3 import dcnv3_core

    gen = torch.Generator(device="cuda").manual_seed(0)
    x, off, m = smoke.dcnv3_inputs(gen, n, side, side, GROUP, gc, 2, 1, 1,
                                   OFFSET_STD)
    x = x.to(torch.bfloat16)
    kw = dict(kernel=3, stride=2, pad=1, dilation=1, group=GROUP,
              offset_scale=1.0, window=WINDOW)
    out = torch.empty(*off.shape[:3], GROUP * gc, device="cuda")
    n_bytes = (x.numel() * 2 + off.numel() * 4 + m.numel() * 4
               + out.numel() * 4)
    bound_us = max(n_bytes / smoke.HBM_BYTES_PER_S,
                   out.numel() * 9 * smoke.FLOP_PER_TAP_CHANNEL
                   / smoke.F32_FLOP_PER_S) * 1e6
    totals.setdefault("bound", 0.0)
    totals["bound"] += bound_us
    k = min(n, VERIFY_IMAGES)
    ref = dcnv3_core(x[:k].float(), off[:k], m[:k], **{
        a: kw[a] for a in ("stride", "pad", "dilation", "group", "window")})

    def call(v):
        part, plan = split_variant(v)
        if v == "fused":
            part = "parent"
        if part == "prep_only":
            xc, oc, mc = (torch.empty_like(t) for t in (x, off, m))
            return lambda: (xc.copy_(x), oc.copy_(off), mc.copy_(m))
        if part == "b1_window4":
            return b1_call(*libs[part], x, off, m, out, kw)
        if part not in libs:
            raise LookupError(f"no library for {part}")
        return win_call(*libs[part], x, off, m, out, kw, plan)

    def timed(v):
        try:
            fn = call(v)
            fn()
        except (LookupError, RuntimeError) as e:
            smoke.log(f"  {label} {v:<14} left out: {e}")
            return None
        return smoke.time_ms(fn, reps, flush) * 1e3

    def error(v) -> float:
        out.fill_(float("nan"))
        call(v)()
        torch.cuda.synchronize()
        return (out[:k] - ref).abs().max().item()

    bar = smoke.KERNEL_BAR * ref.abs().max().item()
    side_by = ("fused", "b1_window4", "full")
    first = {v: timed(v) for v in side_by}

    def beside():
        return (f"parent {fmt(first['fused'])}, B1 window4 "
                f"{fmt(first['b1_window4'])}, bound {bound_us:.1f} us "
                f"[{card}]")

    for v in variants:
        if v == "verify":
            for p in ["full"] + [p for p in variants if p == "mono" or (
                    p.startswith("chunk") and not p.endswith("_bf16"))]:
                try:
                    err = error(p)
                except LookupError as e:
                    smoke.log(f"  {label} verify {p}: left out: {e}")
                    continue
                ok = err <= bar
                smoke.log(f"  {label} verify {p:<8} max_abs_err {err:.3e} "
                          f"(bar {bar:.3e}, {k} images) "
                          f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{label} {p}")
            continue
        if v in side_by:
            continue
        us = timed(v)
        if us is None:
            continue
        totals[v] = totals.get(v, 0.0) + us
        note = ""
        if v.endswith("_bf16"):
            note = f" max_abs_err {error(v):.3e} (not held; bar {bar:.3e})"
        smoke.log(f"  {label} {v:<14} {us:8.1f} us{note}; {beside()}")
    again = {v: timed(v) for v in side_by}
    for v in side_by:
        name = {"fused": "parent (fused)", "b1_window4": "B1 window4",
                "full": "full"}[v]
        smoke.log(f"  {label} {name:<14} {fmt(first[v])} then "
                  f"{fmt(again[v])} us; bound {bound_us:.1f} us [{card}]")
        if first[v] is not None:
            totals[v] = totals.get(v, 0.0) + (first[v] + again[v]) / 2


def fmt(us) -> str:
    return "n/a" if us is None else f"{us:.1f}"


def main(argv: list[str]) -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("channels", type=int, nargs="?", default=256)
    ap.add_argument("variants", nargs="?", default=DEFAULT_VARIANTS)
    ap.add_argument("--layers", action="store_true",
                    help="also the three MAPEncoder layers at batch 32")
    ap.add_argument("--csrc", default=None,
                    help="the windowed kernel to time beside every row "
                         "(default: this checkout's)")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("win_kernel_split: needs an NVIDIA GPU")
    if args.channels % GROUP:
        sys.exit(f"win_kernel_split: channels must divide into {GROUP} "
                 "groups")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    variants = [("fused" if v in ("fused1", "fused2") else v)
                for v in args.variants.split(",")]
    parts = sorted({split_variant(v)[0] for v in variants} - {
        "verify", "prep_only", "fused"} | {"full"})
    card = smoke.card_line()
    smoke.log(f"{card}\n parent: {args.csrc or 'this checkout'}")
    libs = build_all(parts, args.csrc, smoke.log)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    failures: list = []
    totals_by: dict = {}
    for label, n, side, gc in shapes(args.batch, args.channels, args.layers,
                                     smoke):
        totals = totals_by.setdefault(label.startswith("b7"), {})
        run_shape(label, n, side, gc, variants, libs, smoke, card, flush,
                  args.reps, totals, failures)
        torch.cuda.empty_cache()
    if args.layers:
        totals = totals_by[False]
        for v, us in totals.items():
            smoke.log(f"  three layers batch {smoke.BATCH} {v:<14} "
                      f"{us:8.1f} us [{card}]")
    if failures:
        smoke.fail(f"win_kernel_split: plans disagree with the plain "
                   f"version: {failures}")


if __name__ == "__main__":
    main(sys.argv[1:])
