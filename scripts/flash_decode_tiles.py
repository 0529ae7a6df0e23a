#!/usr/bin/env python3
"""Block sweep of the decode kernel (B11 ``flash_decode``:
``csrc/flash_decode.cu``) on the card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/flash_decode_tiles.py

Each block configuration (warps per block, keys in flight per key
group, blocks per SM promised to the compiler by ``__launch_bounds__``)
is a copy of the source with those three constants changed, built with
the port's nvcc flags (one ``nvcc`` each, all at once) into its own
library; the chunk plan (``decode_plan``: the blocks it aims at and the
least chunk) follows the configuration. Each runs B11 at the generation
path's shape (8 slots, T 2048, 12 heads, D 64) read in place through a
permuted page table, at chip_smoke's path lengths and at the lengths of
phase 8's decode step (17, 200, 700 and 1500, twice), in f32, bf16 and
on an int8 pool, and at the bf16 head-dim cases (S 4, T 1024; D 128 at
8 heads, D 256 at 4), paged and through the dense entry. Outputs are
held against the first configuration's within chip_smoke's tolerance,
and each is timed in device ms per launch (``chip_smoke.time_ms``),
the configurations in turn and then in reverse order (the better of
the two kept). The first row is the configuration the port builds.
Prints a table and writes ``chiprun_out/flash_decode_tiles.json``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
# name: (warps, keys in flight per group, blocks per SM, blocks the plan
# aims at, least chunk)
CONFIGS = {
    "w8_u2_b4": (8, 2, 4, 4 * 132, 64),
    "w8_u4_b2": (8, 4, 2, 4 * 132, 0),
    "w8_u2_b4_2x": (8, 2, 4, 8 * 132, 64),
    "w16_u2_b2": (16, 2, 2, 4 * 132, 0),
    "w4_u4_b4": (4, 4, 4, 4 * 132, 64),
}
STEP_LENS = [17, 200, 700, 1500] * 2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cuda_build):
    """One library per configuration; returns name -> (CDLL, ptxas's
    registers and spill bytes per instance)."""
    src_dir = os.path.join(OUT, "flash_decode_tiles")
    os.makedirs(src_dir, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_decode.cu")) as f:
        src = f.read()
    procs = {}
    for name, (warps, unroll, blocks, _, _) in CONFIGS.items():
        s = src
        for old, new in (("constexpr int kWarps = 8;",
                          f"constexpr int kWarps = {warps};"),
                         ("constexpr int kUnroll = 2;",
                          f"constexpr int kUnroll = {unroll};"),
                         ("constexpr int kMinBlocks = 4;",
                          f"constexpr int kMinBlocks = {blocks};")):
            if old not in s:
                raise RuntimeError(f"flash_decode.cu has no {old!r}")
            s = s.replace(old, new)
        path = os.path.join(src_dir, name + ".cu")
        with open(path, "w") as f:
            f.write(s)
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xcompiler",
               "-fno-gnu-unique", "-o", path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             log)]
        libs[name] = (ctypes.CDLL(os.path.join(src_dir, name + ".so")),
                      {"registers": sorted(set(regs)),
                       "spill_bytes_max": max(spills or [0])})
    return libs


def cases(cs):
    """(tag, call) at the sweep's shapes, inputs from numpy and torch
    seeds as chip_smoke's decode cases make them."""
    import torch

    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    path = cs.decode_lens(cs.GEN_SLOTS, cs.GEN_T, 0)
    out = []
    base = ("paged", cs.GEN_SLOTS, cs.GEN_T, 12, 64)
    for dt, int8 in (("float32", False), ("bfloat16", False),
                     ("float32", True)):
        for lens_tag, lens in (("path", path), ("step", STEP_LENS)):
            case = (f"{lens_tag} {dt}{' int8' if int8 else ''}",
                    *base[1:], dt, lens, int8, 0, True)
            out += _calls(cs, fa, case, g, paged_only=True)
    for d, h in ((128, 8), (256, 4)):
        case = (f"d{d} bfloat16", 4, 1024, h, d, "bfloat16",
                [1, 1024, 0, 613], False, 0, True)
        out += _calls(cs, fa, case, g, paged_only=False)
    return out


def _calls(cs, fa, case, g, paged_only):
    import torch
    xdt = getattr(torch, case[5])

    def randn(*shape):
        return (torch.randn(*shape, generator=g) * 0.5).to("cuda", xdt)
    x = cs.decode_inputs(case, randn)
    q, dk, dv, km, dkw = x["dense"]
    calls = [(f"{case[0]} paged", lambda: fa.flash_decode_paged(
        q, x["k"], x["v"], x["table"], x["lens"], x["scale"],
        **x["scales"]))]
    if not paged_only:
        calls.append((f"{case[0]} dense", lambda: fa.flash_decode_attention(
            q, dk, dv, km, x["scale"], **dkw)))
    return calls


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_decode_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    cs = _chip_smoke()
    card = cs.card_line()
    print(card, flush=True)
    libs = build(cuda_build)
    calls = cases(cs)
    ms, ref, worst = {}, {}, 0.0
    order = list(CONFIGS) + list(CONFIGS)[::-1]
    for name in order:
        warps, unroll, _, target, least = CONFIGS[name]
        fn = libs[name][0].flash_decode_launch
        fn.argtypes = fa._SIGNATURES["flash_decode"]
        fn.restype = ctypes.c_int
        fa._fns["flash_decode"] = fn
        fa._DECODE_WARPS, fa._DECODE_UNROLL = warps, unroll
        fa._DECODE_BLOCKS, fa._DECODE_MIN_CHUNK = target, least
        fa.decode_plan.cache_clear()   # the plan follows the constants
        for tag, call in calls:
            got = call()
            if tag not in ref:
                ref[tag] = got
            err, tol, _ = cs.flash_err(got, ref[tag], str(got.dtype)[6:])
            worst = max(worst, err / tol)
            if err > tol:
                raise AssertionError(f"{name} {tag}: max|err| {err} > {tol}")
            t = cs.time_ms(call, iters=20)
            ms[(tag, name)] = min(ms.get((tag, name), t), t)
    fa._fns.pop("flash_decode")
    head = ["case"] + list(CONFIGS)
    print("| " + " | ".join(head) + " |")
    print("|" + "---|" * len(head))
    for tag, _ in calls:
        print("| " + " | ".join([tag] + [f"{ms[(tag, n)]:.4f}"
                                         for n in CONFIGS]) + " |")
    for name, (_, info) in libs.items():
        print(f"{name}: registers {info['registers']}, at most "
              f"{info['spill_bytes_max']} bytes spilled", flush=True)
    print(f"outputs within tolerance of the first configuration's (worst "
          f"{worst:.3f} of it); {card}", flush=True)
    with open(os.path.join(OUT, "flash_decode_tiles.json"), "w") as f:
        json.dump({"card": card, "configs": CONFIGS,
                   "ms": {f"{t} | {n}": v for (t, n), v in ms.items()},
                   "builds": {n: info for n, (_, info) in libs.items()}},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
