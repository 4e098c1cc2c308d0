"""Attribute the time of kernel A's tensor-core assign pass
(``csrc/fused_assign_tc.cuh``) on the card by ablation: each variant is a
copy of a kernel source directory with one part of the pass taken out,
built apart and timed through the port's ``fused_assign`` at the kernel
checks' shapes (``chip_smoke.Case``):

* ``base``: the source as it is;
* ``no_product``: no ``wgmma`` issued (the sums start at spread values, so
  the argmax draws as few noises as on real data);
* ``no_phi``: no phi tile copied (the barriers still count the copies'
  bytes as arrived);
* ``no_rows``: no rows loaded, built or stored (nor the points staged;
  for the tensor-map design, no rows' copy);
* ``no_epilogue``: no Gumbel argmax fold (labels still written).

A variant's time against ``base`` is what that part costs beyond what the
rest hides.  Each time is the device time of the pass's kernels
(``stage_phi_kernel`` and ``assign_tc_kernel``, ``assign_tma_kernel`` or
``assign_resident_kernel``)
a call, by torch.profiler
over 3 calls after a warm-up (``chip_smoke.device_ms_by_kernel``): the
statistics pass after it is left out, as its time depends on the labels,
which the ablated kernels make nonsense of.  One JSON line a (variant,
shape), with the card's name and power limit.

    python scripts/tc_attribution.py [--src DIR] [--variants a,b] \\
        [--shapes gaussian,hybrid,precomputed,bfloat16,multinomial] \\
        [--design NAME] [--live N]

``--src`` names another tree's ``csrc`` (a ``git archive`` of an earlier
commit): its kernels are built and driven through this tree's wrappers
(the C interface is the same).  ``--design`` picks the ablations' kernel
("tma": fused_assign_tc_tma.cuh, which one bf16 pass over a bf16 cache
at a pass width of 256 takes; "ring": fused_assign_tc_ring.cuh, the two
planes there; "resident": fused_assign_tc_resident.cuh, the narrow passes
whose phi fits in one SM; "column halves": fused_assign_tc.cuh, the rest);
by default
the newest one the source holds, at the shapes that take it (``--shapes``
overrides).  ``--live N`` makes the slots past the first N inactive
(log_w -inf), as the 10M cells' K=100 at a table width of 256, or the
20M counts cell's K=20 at 64 slots (``--shapes multinomial --live 20``).
Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import _build  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402

# (old, new) text replacements in fused_assign_tc.cuh a variant applies;
# each design of the kernel has its own table, picked by its first pattern
PATCHES = {
    # the 64-point, column-half kernel (two warpgroups, __syncthreads a step)
    "column halves": {
        "no_product": [
            ("wgmma_bf16(acc, da + 2 * kk, db + kPhiPlane / 16 + 2 * kk);",
             "if (false) wgmma_bf16(acc, da + 2 * kk, db + kPhiPlane / 16 + "
             "2 * kk);"),
            ("wgmma_bf16(acc, da + kTcRowTile / 16 + 2 * kk, db + 2 * kk);",
             "if (false) wgmma_bf16(acc, da + kTcRowTile / 16 + 2 * kk, db "
             "+ 2 * kk);"),
            ("        wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);",
             "        if (false) wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);"),
            ("for (int i = 0; i < N / 4; ++i) acc[i] = 0.0f;",
             "for (int i = 0; i < N / 4; ++i) acc[i] = 100.0f * i;"),
        ],
        "no_phi": [
            ("mbar_expect(bar, Planes * kPhiPlane);",
             "mbar_expect(bar, 0); if (false)"),
        ],
        "no_rows": [
            ("auto load_rows = [&](int ks, float (&out)[kTcHeld]) {",
             "auto load_rows = [&](int ks, float (&out)[kTcHeld]) {\n"
             "    if (ks >= 0) { for (int i = 0; i < kTcHeld; ++i) "
             "out[i] = 0.0f; return; }"),
            ("auto store_rows = [&](int stage, const float (&in)[kTcHeld]) {",
             "auto store_rows = [&](int stage, const float (&in)[kTcHeld]) {"
             "\n    if (stage >= 0) return;"),
            ("const int stage_x =\n      x_bytes > 0",
             "const int stage_x =\n      false && x_bytes > 0"),
        ],
        "no_epilogue": [
            ("const int col0 = pass * (N / 2) + col_half * kQuarter + "
             "2 * (lane & 3);",
             "const int col0 = pass * (N / 2) + col_half * kQuarter + "
             "2 * (lane & 3);\n    if (col0 >= 0) { best[0].v = acc[0]; "
             "best[1].v = acc[1]; continue; }"),
        ],
    },
    # the 128-point persistent kernel (a producer warpgroup, a ring of
    # stages, phi multicast to a cluster of two)
    "ring": {
        "no_product": [
            ("            wgmma_bf16(acc, da + 2 * kk, db + kPhiPlane / 16 + "
             "2 * kk);",
             "            if (false) wgmma_bf16(acc, da + 2 * kk, db + "
             "kPhiPlane / 16 + 2 * kk);"),
            ("            wgmma_bf16(acc, da + kTcRowTile / 16 + 2 * kk, db + "
             "2 * kk);",
             "            if (false) wgmma_bf16(acc, da + kTcRowTile / 16 + "
             "2 * kk, db + 2 * kk);"),
            ("          wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);",
             "          if (false) wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);"),
            ("for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;",
             "for (int i = 0; i < N / 2; ++i) acc[i] = 100.0f * i;"),
        ],
        "no_phi": [
            ("      mbar_expect(grid.full_bar(s), Planes * "
             "Shape::kPhiPlane);\n      bulk_copy_multicast(",
             "      mbar_arrive(grid.full_bar(s));\n      if (false) "
             "bulk_copy_multicast("),
        ],
        "no_rows": [
            ("        for (int c = 0; c < rows.d; ++c)",
             "        for (int c = 0; c < 0; ++c)"),
            ("      for (int i = 0; i < kTcProducerRows; ++i, p += rows.f) {",
             "      for (int i = 0; i < 0; ++i, p += rows.f) {"),
            ("      for (int i = 0; i < kTcConsumerRows; ++i, xr += rows.d)\n"
             "        store_pair",
             "      for (int i = 0; i < 0; ++i, xr += rows.d)\n"
             "        store_pair"),
            ("      for (int i = 0; i < kTcConsumerRows; ++i, xr += rows.d) {",
             "      for (int i = 0; i < 0; ++i, xr += rows.d) {"),
            ("    for (int i = 0; i < kTcConsumerRows; ++i, p += rows.ld) {",
             "    for (int i = 0; i < 0; ++i, p += rows.ld) {"),
            ("          for (int j = 0; j < pieces; ++j) {",
             "          for (int j = 0; j < 0; ++j) {"),
            ("      for (int i = 0; i < kTcConsumerRows; ++i) {",
             "      for (int i = 0; i < 0; ++i) {"),
        ],
        "no_epilogue": [
            # the fold is ring::fold_pass, a function of its own: return
            ("const int col0 = pass * (N / 2) + 2 * (lane & 3);",
             "const int col0 = pass * (N / 2) + 2 * (lane & 3);\n      if "
             "(col0 >= 0) { best[0].v = acc[0]; best[1].v = acc[1]; "
             "return; }"),
        ],
    },
}
PATCHES["tma"] = {
    # one bf16 pass over a bf16 cache at a pass width of 256: the rows by a
    # tensor-map copy, phi multicast, no thread touching a row
    "no_product": [
        ("          wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);",
         "          if (false) wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);"),
        ("for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;",
         "for (int i = 0; i < N / 2; ++i) acc[i] = 100.0f * i;"),
    ],
    "no_phi": [
        ("    mbar_expect(w.full_bar(s), kRowTile + kPhiTile);",
         "    mbar_expect(w.full_bar(s), kRowTile);"),
        ("    ring::bulk_copy_multicast(",
         "    if (false) ring::bulk_copy_multicast("),
    ],
    "no_rows": [
        ("    mbar_expect(w.full_bar(s), kRowTile + kPhiTile);\n"
         "    tma_load_rows(",
         "    mbar_expect(w.full_bar(s), kPhiTile);\n"
         "    if (false) tma_load_rows("),
    ],
    "no_epilogue": PATCHES["ring"]["no_epilogue"],
}
PATCHES["resident"] = {
    # the narrow passes' persistent kernel: phi resident, a producer warp
    # streaming 64-point tiles, two column-half warpgroups
    "no_product": [
        ("        wgmma_bf16(acc, da + 2 * kk, db + kPhiPlane / 16 + 2 * kk);",
         "        if (false) wgmma_bf16(acc, da + 2 * kk, db + kPhiPlane / 16 "
         "+ 2 * kk);"),
        ("        wgmma_bf16(acc, da + kTcRowTile / 16 + 2 * kk, db + 2 * kk);",
         "        if (false) wgmma_bf16(acc, da + kTcRowTile / 16 + 2 * kk, "
         "db + 2 * kk);"),
        ("      wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);",
         "      if (false) wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);"),
        ("\n  for (int j = 0; j < N / 4; ++j) acc[j] = 0.0f;",
         "\n  for (int j = 0; j < N / 4; ++j) acc[j] = 100.0f * j;"),
        ("\n    for (int j = 0; j < N / 4; ++j) acc[j] = 0.0f;",
         "\n    for (int j = 0; j < N / 4; ++j) acc[j] = 100.0f * j;"),
    ],
    "no_phi": [
        ("    mbar_expect(bars, lay.phi_bytes());",
         "    mbar_arrive(bars);"),
        ("      bulk_copy(base + s * step_bytes,",
         "      if (false) bulk_copy(base + s * step_bytes,"),
    ],
    "no_rows": [
        ("        mbar_expect(full, tile_src);\n        bulk_copy(",
         "        mbar_arrive(full);\n        if (false) bulk_copy("),
        ("        for (int u = lane; u < units; u += 32)",
         "        for (int u = lane; u < 0; u += 32)"),
        ("    load_rows(rows, smem + lay.buf(b), s, f, warp, lane, held);\n"
         "    store_rows<Planes>(smem + lay.row_tile(pipe, g & 1), warp, lane, "
         "held);", ""),
    ],
    "no_epilogue": [
        ("    best[0] = best[1] = {-INFINITY, 0x7fffffff, 0.0f};\n"
         "#pragma unroll\n    for (int h = 0; h < 2; ++h) {",
         "    best[0] = best[1] = {acc[0], 0, acc[1]};\n"
         "    for (int h = 0; h < 2 && col0 < 0; ++h) {"),
    ],
}
# the file each design's kernel lives in, oldest first
HEADERS = {"column halves": "fused_assign_tc.cuh",
           "ring": "fused_assign_tc_ring.cuh",
           "tma": "fused_assign_tc_tma.cuh",
           "resident": "fused_assign_tc_resident.cuh"}
# the shapes each design's kernel takes (chip_smoke.Case's)
DESIGN_SHAPES = {"column halves": "gaussian,hybrid,precomputed",
                 "ring": "gaussian,hybrid,precomputed",
                 "tma": "hybrid,bfloat16",
                 "resident": "multinomial"}
SHAPES = ("gaussian", "hybrid", "precomputed", "bfloat16", "multinomial")


def variant_lib(src: pathlib.Path, name: str, header: str,
                patches) -> ctypes.CDLL:
    """Build ``src`` with ``patches`` applied to ``header`` into the build
    directory; the library, its entry points typed."""
    work = _build.BUILD_DIR / f"attribution_{name}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, work)
    head = work / header
    text = head.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: pattern found {text.count(old)} "
                               f"times: {old!r}")
        text = text.replace(old, new)
    head.write_text(text)
    return typed_lib(_build.build(verbose=True, src_dir=work))


def typed_lib(path) -> ctypes.CDLL:
    """The library at ``path``, its entry points typed (those an earlier
    tree's library lacks are left out)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _build._RESTYPES.get(fn, ctypes.c_int)
    return lib


def shape_case(torch, dev, shape: str):
    """The kernel checks' inputs (``chip_smoke.check_kernels``): the
    10M x 64-d fit's rows (D=64, F=2145, K=256) built, or as a hybrid bf16
    cache; the flagship's f32 or bf16 cache (D=32, F=561, K=128); the
    multinomial fits' counts (1M x 100-d, F=101, K=64: a pass width of
    128)."""
    if shape == "multinomial":
        from dpmmsubclusters_tpu_torch.utils.generators import (
            generate_mnmm_data)

        x, _, _ = generate_mnmm_data(cs.N_CHECK, 100, 20, 120, seed=1)
        return cs.Case(torch, dev, x, "multinomial", 64)
    if shape == "precomputed":
        x, _ = cs.separated_data(cs.N_CHECK, cs.D_FLAG, cs.K_TRUE_FLAG)
        x = (x - x.mean(0)) / x.std(0)
        return cs.Case(torch, dev, x, "gaussian", cs.K_MAX_FLAG,
                       cache="float32")
    if shape == "bfloat16":
        x, _ = cs.separated_data(cs.N_CHECK, cs.D_FLAG, cs.K_TRUE_FLAG)
        x = (x - x.mean(0)) / x.std(0)
        return cs.Case(torch, dev, x, "gaussian", cs.K_MAX_FLAG,
                       cache="bfloat16")
    x, _ = cs.separated_data(cs.N_CHECK, 64, 100)
    x = (x - x.mean(0)) / x.std(0)
    if shape == "hybrid":
        return cs.Case(torch, dev, x, "gaussian", 256,
                       cache="bfloat16").as_hybrid()
    return cs.Case(torch, dev, x, "gaussian", 256)


def main() -> int:
    import torch

    from dpmmsubclusters_tpu_torch.utils import profiling

    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(_build.CSRC))
    ap.add_argument("--variants", default="")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--ll-precision", default="default")
    ap.add_argument("--design", default="", choices=("",) + tuple(HEADERS))
    ap.add_argument("--live", type=int, default=0,
                    help="slots past the first LIVE inactive (log_w -inf), "
                         "as the 10M cells' K=100 at a width of 256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tc_attribution: CUDA is not available", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    design = args.design or next(d for d in reversed(HEADERS)
                                 if (src / HEADERS[d]).exists())
    shapes = (args.shapes or DESIGN_SHAPES[design]).split(",")
    names = ["base"] + list(PATCHES[design])
    if args.variants:
        names = [n for n in names if n in args.variants.split(",")]
    libs = {n: variant_lib(src, n, HEADERS[design],
                           PATCHES[design].get(n, ())) for n in names}
    dev = torch.device("cuda")
    smi = profiling.card(dev)
    main_load = _build.load
    for shape in shapes:
        case = shape_case(torch, dev, shape)
        if args.live:
            case.log_w[args.live:] = float("-inf")
        kw = dict(case.kw(), ll_precision=args.ll_precision)
        for name in names:
            _build.load = lambda lib=libs[name]: lib
            try:
                by_kernel = cs.device_ms_by_kernel(torch, lambda: (
                    sk.fused_assign(*case.args(), False, **kw)))
            finally:
                _build.load = main_load
            pass_ms = sum(v for kname, v in by_kernel.items()
                          if kname in ("assign_tc_kernel",
                                       "assign_tma_kernel",
                                       "assign_resident_kernel",
                                       "stage_phi_kernel"))
            print(json.dumps(dict(design=design, variant=name, shape=shape,
                                  k=case.k, live=args.live or case.k,
                                  f=case.phi_mat.shape[0],
                                  ll_precision=args.ll_precision,
                                  pass_ms=pass_ms, by_kernel=by_kernel,
                                  card=smi)), flush=True)
        del case
        cs.free(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
