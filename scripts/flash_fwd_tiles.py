#!/usr/bin/env python3
"""Tile sweep of the flash-attention forward template (B7 ``flash_fwd``,
B8 ``flash_block``: ``csrc/flash_fwd_sm90.cuh``) on the card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/flash_fwd_tiles.py

Each (dtype, head dim) gets one library, built with the port's nvcc
flags (one ``nvcc`` each, all at once), that holds the template's
instances at every tile of the sweep: consumer warpgroups (64 query
rows each) and keys per walked tile. Each instance runs B8 and B7 at
BERT-base's shapes (the Estimator's f32 batch 16 at T 512 with padding
masks, bench_bert's batch 32 at T 128) and at longer causal and full
sequences, on q, k, v sliced from one projection as BERT has them; its
outputs are held against the plain versions within chip_smoke's
tolerance (``flash_err``), and B8 and B7 are timed in device ms per
launch (``chip_smoke.time_ms``) beside SDPA's forward on the same
inputs. The tile ``fwd_tile`` in ``ops/flash_attention.py`` names is
the one the port builds. Prints a table and writes
``chiprun_out/flash_fwd_tiles.json``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
# (dtype, D) -> [(warpgroups, keys per tile)]; f32 at D 128 fits shared
# memory only at one warpgroup and 32 keys
SWEEP = {
    ("bfloat16", 64): [(1, 64), (1, 128), (2, 64), (2, 128)],
    ("bfloat16", 128): [(1, 64), (1, 128), (2, 64), (2, 128)],
    ("float32", 64): [(1, 32), (1, 64), (2, 32), (2, 64)],
    ("float32", 128): [(1, 32)],
}
# (tag, B, T, H, causal, key mask kind of chip_smoke._key_mask)
SHAPES = {
    64: [("bert_estimator", 16, 512, 12, False, "lengths"),
         ("bert_bench", 32, 128, 12, False, "ones"),
         ("causal_1k", 2, 1024, 8, True, None),
         ("causal_2k", 4, 2048, 12, True, None),
         ("full_2k", 4, 2048, 12, False, None)],
    128: [("lengths_1k", 8, 1024, 8, False, "lengths"),
          ("causal_2k", 2, 2048, 8, True, None)],
}
CTYPE = {"bfloat16": "__nv_bfloat16", "float32": "float"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cuda_build):
    """One library per (dtype, D) with an ``<name>(variant, partial,
    ...)`` entry over the sweep's tiles; returns the loaded functions."""
    build_dir = os.path.join(cuda_build.BUILD_DIR, "tiles")
    os.makedirs(build_dir, exist_ok=True)
    header = os.path.join(cuda_build.CSRC_DIR, "flash_fwd_sm90.cuh")
    procs = {}
    for (dt, d), tiles in SWEEP.items():
        name = f"fwd_tiles_{dt}_{d}"
        cases = "\n".join(
            f"    case {i}: return partial ? zoo::ffwd::launch_tile<"
            f"{CTYPE[dt]}, {d}, true, {w}, {r}>(a, s) : zoo::ffwd::"
            f"launch_tile<{CTYPE[dt]}, {d}, false, {w}, {r}>(a, s);"
            for i, (w, r) in enumerate(tiles))
        src = (f'#include "{header}"\n'
               f'extern "C" int {name}(int variant, int partial, '
               'const void* q, const void* k, const void* v, '
               'const void* kmask, void* o, void* m, void* l, int B, '
               'int H, int Tq, int Tk, long long q_sb, long long q_st, '
               'long long k_sb, long long k_st, long long v_sb, '
               'long long v_st, int causal, int off, float scale, '
               'void* stream) {\n'
               '  const zoo::flash::FwdArgs a = zoo::flash::make_fwd_args('
               'q, k, v, kmask, o, m, l, B, H, Tq, Tk, q_sb, q_st, k_sb, '
               'k_st, v_sb, v_st, causal, off, scale);\n'
               '  cudaStream_t s = static_cast<cudaStream_t>(stream);\n'
               f'  switch (variant) {{\n{cases}\n  }}\n  return -1;\n}}\n')
        cu = os.path.join(build_dir, name + ".cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(build_dir, f"lib{name}.so")
        # -fno-gnu-unique: the launchers' function-local statics must not
        # be shared with the port's own copy of the same instance
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xcompiler",
               "-fno-gnu-unique", "-o", so, cu]
        procs[(dt, d)] = (name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    p_, i_, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for key, (name, so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(so), name)
        fn.argtypes = [i_, i_] + [p_] * 7 + [i_] * 4 + [l_] * 6 + \
            [i_, i_, ctypes.c_float, p_]
        fn.restype = i_
        fns[key] = fn
    return fns


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_fwd_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    fns = build(cuda_build)
    dev = torch.device("cuda")
    rows, ok = [], True
    for (dt, d), tiles in SWEEP.items():
        xdt = getattr(torch, dt)
        chosen = fa.fwd_tile("flash_block", d, xdt)
        for tag, b, t, h, causal, mkind in SHAPES[d]:
            g = torch.Generator(device="cuda").manual_seed(0)
            qkv = (torch.randn(b, t, 3 * h * d, generator=g, device=dev) *
                   0.5).to(xdt)
            q, k, v = [x.reshape(b, t, h, d) for x in qkv.split(h * d, -1)]
            km = cs._key_mask(b, t, mkind, dev)
            scale = d ** -0.5
            want = (*fa.flash_block_ref(q, k, v, km, causal, scale, 0),
                    fa.flash_fwd_ref(q, k, v, km, causal, scale))
            lq, lk, lv = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
            idx = torch.arange(t, device=dev)
            keep = (idx[:, None] >= idx[None, :])[None] if causal else \
                torch.ones(1, t, t, dtype=torch.bool, device=dev)
            if km is not None:
                keep = keep & (km[:, None, :] > 0)
            sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=keep[:, None]), iters=20)
            for i, (w, r) in enumerate(tiles):
                outs = (torch.empty(b, t, h, d, device=dev),
                        torch.empty(b, h, t, device=dev),
                        torch.empty(b, h, t, device=dev),
                        torch.empty(b, t, h, d, device=dev, dtype=xdt))

                def run(partial, i=i, outs=outs):
                    o = outs[0] if partial else outs[3]
                    rc = fns[(dt, d)](
                        i, partial, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), None if km is None else km.data_ptr(),
                        o.data_ptr(), outs[1].data_ptr() if partial else None,
                        outs[2].data_ptr() if partial else None, b, h, t, t,
                        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                        v.stride(0), v.stride(1), int(causal), 0, scale,
                        torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: CUDA error {rc}")
                run(1)
                run(0)
                torch.cuda.synchronize()
                errs = [cs.flash_err(x, y, dt) for x, y in zip(outs, want)]
                right = all(e <= tol for e, tol, _ in errs)
                ok &= right
                rec = {"dtype": dt, "d": d, "shape": tag, "B": b, "T": t,
                       "H": h, "causal": causal, "mask": mkind,
                       "warpgroups": w, "keys": r, "right": right,
                       "port_tile": (w, r) == (chosen[0], chosen[2]),
                       "b8_ms": cs.time_ms(lambda: run(1), iters=20),
                       "b7_ms": cs.time_ms(lambda: run(0), iters=20),
                       "sdpa_ms": sdpa}
                rows.append(rec)
                print(f"  {dt} D {d} {tag}: tile ({w}, {r})"
                      f"{' [port]' if rec['port_tile'] else ''} B8 "
                      f"{rec['b8_ms']:.4f} ms, B7 {rec['b7_ms']:.4f} ms, "
                      f"SDPA {sdpa:.4f} ms, right {right}", flush=True)
            del q, k, v, qkv, lq, lk, lv
            torch.cuda.empty_cache()
    print(card)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "flash_fwd_tiles.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(json.dumps({"card": card, "all_right": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
