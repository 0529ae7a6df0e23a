#!/usr/bin/env python3
"""B3 and B6 of the PyTorch/CUDA port on the card, one checkout against
another, and B2's outputs compared bit for bit.

Run from the repository root on a machine with one CUDA card, with
another checkout (for example the parent commit, unpacked by
``git archive``) at DIR:

    python3 scripts/conv_bn_ab.py --base DIR

Four processes run in turn: the base checkout, this one, this one
again, the base again (each builds its own kernels from its ``csrc/``).
Each times, in device milliseconds per launch (CUDA events,
``chip_smoke.time_ms``):

- B3, the bf16 dx kernel (``_matmul_bn_dx``), at ResNet-50's 16 1x1
  train-step shapes at batch 128, beside cuBLAS's ``dy @ W^T`` on the
  same inputs and the shape's bound;
- B6, the bf16 3x3 fold (``conv3x3_bn_apply``), at ResNet-50's 7 3x3
  serving shapes at batch 1, 8 and 32, beside cuDNN's conv;

and saves B2's bf16 outputs (``_conv3x3_bn_fwd``: y and both
statistics) at six shapes that take each of its kernels and tiles. A
checkout that has the tile helpers (``dx_tile``,
``conv3x3_apply_tile``) also times every tile width of B3 and every
kernel and tile of B6 at each of those shapes, each checked against its
plain version. The script prints one table per kernel (the first run of
each checkout, the second beside it as the spread), the tile sweeps,
whether B2's outputs are equal bit for bit across the checkouts, and a
JSON line; the details go to ``chiprun_out/conv_bn_ab.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
SERVE_BATCHES = (1, 8, 32)
# B2's kernels and tiles: window 128- and 64-wide, generic 256 and 128
B2_SHAPES = [(4, 56, 56, 64, 64, 1), (4, 28, 28, 128, 128, 1),
             (4, 56, 56, 128, 128, 2), (4, 28, 28, 256, 256, 2),
             (4, 14, 14, 512, 512, 2), (3, 7, 7, 512, 512, 1)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str, out: str) -> None:
    """Time and save one checkout's kernels (see the module note)."""
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    if not os.path.abspath(cb.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {cb.__file__}, not from {tree}")
    cs = _chip_smoke()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)

    def err_tol(got, want):
        """The worst output's error and its tolerance, each output held
        within 2e-2 of max(1, its max|plain|), chip_smoke's bound."""
        pairs = [((a.float() - b.float()).abs().max().item(),
                  2e-2 * max(1.0, b.float().abs().max().item()))
                 for a, b in zip(got, want) if b is not None]
        return max(pairs, key=lambda p: p[0] / p[1])

    cb.build_kernels()
    net = ImageClassifier("resnet-50", input_shape=cs.IMAGE, classes=1000,
                          fused=True).model
    net.init(torch.Generator().manual_seed(0))
    b1, _ = cs.train_shapes(net, cs.TRAIN_BATCH)
    res = {"tree": tree, "b3": [], "b6": [], "b3_tiles": [],
           "b6_tiles": []}

    for key, per_step in sorted(b1.items()):
        b, h, w, k, n, stride, affine, has_r = key
        m = b * -(-h // stride) * -(-w // stride)
        x = randn(m, k, dtype=bf)
        wt = randn(k, n, scale=k ** -0.5, dtype=bf)
        s = 1.0 + randn(k, scale=0.1) if affine else None
        t = randn(k, scale=0.1) if affine else None
        r = randn(m, k, dtype=bf) if has_r else None
        args = (x, wt, s, t, r, randn(n, scale=0.1), randn(m, n, dtype=bf),
                randn(m, n, dtype=bf), randn(n, scale=0.1),
                randn(n, scale=0.01), bool(affine), bool(affine))
        dy = args[7]
        # x is read only for the prologue's mask and ds
        nbytes = (2 * m * n + m * k * (1 + (affine or has_r) + 2 * has_r)
                  + k * n) * 2 + 4 * (2 * k * affine + 3 * n) + \
            4 * 2 * k * affine
        flops = 2.0 * m * k * n
        rec = {"key": list(key), "per_step": per_step,
               "ms": cs.time_ms(lambda: cb._matmul_bn_dx(*args)),
               "library_ms": cs.time_ms(lambda: torch.matmul(dy, wt.t())),
               "bound_ms": max(flops / cs.PEAK_FLOPS["bfloat16"],
                               nbytes / cs.PEAK_BYTES) * 1e3,
               "bound_by": "operations" if flops / cs.PEAK_FLOPS[
                   "bfloat16"] > nbytes / cs.PEAK_BYTES else "bytes",
               "bytes": nbytes, "flops": flops}
        res["b3"].append(rec)
        print(f"  B3 {tuple(key)} x{per_step}: {rec['ms']:.4f} ms",
              flush=True)
        if hasattr(cb, "dx_tile"):
            want = cb.matmul_bn_dx_ref(*args)
            chosen = cb.dx_tile(k)
            real = cb.dx_tile
            for bk in (64, 128, 256):
                if bk > k:
                    continue
                cb.dx_tile = lambda k_, bk=bk: bk
                try:
                    err, tol = err_tol(cb._matmul_bn_dx(*args), want)
                    ms = cs.time_ms(lambda: cb._matmul_bn_dx(*args))
                finally:
                    cb.dx_tile = real
                res["b3_tiles"].append({"key": list(key), "bk": bk,
                                        "chosen": bk == chosen, "ms": ms,
                                        "max_abs_err": err, "tol": tol})
                if not err <= tol:
                    raise AssertionError(f"B3 {key} bk {bk}: {err} > {tol}")
        del args, x, dy, r
        torch.cuda.empty_cache()

    b6_shapes = sorted({k[1:] for k in cs.path_shapes(net, 1)[1]})
    counts = cs.path_shapes(net, 1)[1]
    for batch in SERVE_BATCHES:
        for h, w, cin, cout, stride in b6_shapes:
            x = randn(batch, h, w, cin, dtype=bf)
            wt = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
            os_, ot = 1.0 + randn(cout, scale=0.1), randn(cout, scale=0.1)
            fold = dict(out_scale=os_, out_shift=ot, relu_out=True,
                        stride=stride)
            pt, pb, ho = cb.tf_same_pads(h, 3, stride)
            pl, pr, wo = cb.tf_same_pads(w, 3, stride)
            xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous(
                memory_format=torch.channels_last)
            wl = wt.to(bf).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            m = batch * ho * wo
            flops = 2.0 * m * 9 * cin * cout
            nbytes = (batch * h * w * cin + m * cout + 9 * cin * cout) * 2 \
                + 4 * 2 * cout
            key = (batch, h, w, cin, cout, stride)
            rec = {"key": list(key),
                   "per_forward": counts[(1, h, w, cin, cout, stride)],
                   "ms": cs.time_ms(lambda: cb.conv3x3_bn_apply(x, wt,
                                                                **fold)),
                   "library_ms": cs.time_ms(
                       lambda: F.conv2d(xp, wl, stride=stride)),
                   "bound_ms": max(flops / cs.PEAK_FLOPS["bfloat16"],
                                   nbytes / cs.PEAK_BYTES) * 1e3,
                   "bound_by": "operations" if flops / cs.PEAK_FLOPS[
                       "bfloat16"] > nbytes / cs.PEAK_BYTES else "bytes",
                   "flops": flops}
            res["b6"].append(rec)
            print(f"  B6 {key}: {rec['ms']:.4f} ms", flush=True)
            if hasattr(cb, "conv3x3_apply_tile"):
                want = (cb.conv3x3_bn_apply_ref(x, wt, None, None, os_, ot,
                                                False, False, True,
                                                stride),)
                chosen = cb.conv3x3_apply_tile(batch, h, w, cin, cout,
                                               stride)
                real = cb.conv3x3_apply_tile
                for tile in ((True, 128), (True, 64), (False, 256),
                             (False, 128), (False, 64)):
                    if (tile[0] and (stride != 1 or cb._window_smem(
                            tile[1], cin, w) > cb._SMEM_PER_BLOCK)) or \
                            cout % tile[1]:
                        continue
                    cb.conv3x3_apply_tile = lambda *a_, tile=tile: tile
                    try:
                        err, tol = err_tol(
                            (cb.conv3x3_bn_apply(x, wt, **fold),), want)
                        ms = cs.time_ms(
                            lambda: cb.conv3x3_bn_apply(x, wt, **fold))
                    finally:
                        cb.conv3x3_apply_tile = real
                    res["b6_tiles"].append({
                        "key": list(key), "window": tile[0], "bn": tile[1],
                        "chosen": tile == tuple(chosen), "ms": ms,
                        "max_abs_err": err, "tol": tol})
                    if not err <= tol:
                        raise AssertionError(
                            f"B6 {key} tile {tile}: {err} > {tol}")

    b2 = {}
    for key in B2_SHAPES:
        b, h, w, cin, cout, stride = key
        g2 = torch.Generator(device=dev).manual_seed(hash(key) % 2 ** 31)
        x = torch.randn(b, h, w, cin, generator=g2, device=dev).to(bf)
        wt = torch.randn(3, 3, cin, cout, generator=g2, device=dev) * \
            (9 * cin) ** -0.5
        s = 1.0 + 0.1 * torch.randn(cin, generator=g2, device=dev)
        t = 0.1 * torch.randn(cin, generator=g2, device=dev)
        sh = 0.1 * torch.randn(cout, generator=g2, device=dev)
        y, ssum, ssq = cb._conv3x3_bn_fwd(x, wt, s, t, sh, True, True,
                                          stride)
        b2[str(key)] = [v.cpu() for v in (y, ssum, ssq)]
    torch.save(b2, out + ".b2.pt")
    with open(out, "w") as f:
        json.dump(res, f)


def _table(title, rows, head):
    print(title)
    print("| " + " | ".join(head) + " |")
    print("|" + "---|" * len(head))
    for r in rows:
        print("| " + " | ".join(str(v) for v in r) + " |")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("conv_bn_ab: no CUDA device", file=sys.stderr)
        return 2
    if opts.child:
        child(opts.child, opts.out)
        return 0
    if not opts.base:
        ap.error("--base DIR is required")
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs = [("base", os.path.abspath(opts.base)), ("this", ROOT),
            ("this", ROOT), ("base", os.path.abspath(opts.base))]
    results = []
    for i, (tag, tree) in enumerate(runs):
        out = os.path.join(OUT, f"conv_bn_ab_{i}_{tag}.json")
        print(f"[run {i}: {tag} {tree}]", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", tree, "--out", out], check=True)
        with open(out) as f:
            results.append(json.load(f))
    base, this, this2, base2 = results
    print(card)

    def per_path(recs, n_key):
        return sum(r["ms"] * r[n_key] for r in recs)

    rows = []
    for p, c, c2, p2 in zip(base["b3"], this["b3"], this2["b3"],
                            base2["b3"]):
        rate = c["bytes"] / c["ms"] / 1e6 if c["bound_by"] == "bytes" \
            else c["flops"] / c["ms"] / 1e9
        unit = "GB/s" if c["bound_by"] == "bytes" else "TFLOP/s"
        rows.append((",".join(map(str, c["key"][1:6])) +
                     (",a" if c["key"][6] else "") +
                     (",r" if c["key"][7] else ""), c["per_step"],
                     f"{c['ms']:.4f} ({p['ms']:.4f})",
                     f"{c2['ms']:.4f} / {p2['ms']:.4f}",
                     f"{c['library_ms']:.4f}",
                     f"{c['bound_ms']:.4f} ({c['bound_by'][0]})",
                     f"{rate:.0f} {unit}"))
    _table("B3 bf16, batch 128 (ms per launch; base in brackets; second "
           "runs this / base)", rows,
           ["shape", "x", "ms (base)", "2nd runs", "cuBLAS ms", "bound ms",
            "rate"])
    print(f"B3 per step: this {per_path(this['b3'], 'per_step'):.4f} / "
          f"{per_path(this2['b3'], 'per_step'):.4f} ms, base "
          f"{per_path(base['b3'], 'per_step'):.4f} / "
          f"{per_path(base2['b3'], 'per_step'):.4f} ms, cuBLAS "
          f"{sum(r['library_ms'] * r['per_step'] for r in this['b3']):.4f}"
          f" ms, bound "
          f"{sum(r['bound_ms'] * r['per_step'] for r in this['b3']):.4f} ms")
    rows = []
    for p, c, c2, p2 in zip(base["b6"], this["b6"], this2["b6"],
                            base2["b6"]):
        rows.append((",".join(map(str, c["key"])), c["per_forward"],
                     f"{c['ms']:.4f} ({p['ms']:.4f})",
                     f"{c2['ms']:.4f} / {p2['ms']:.4f}",
                     f"{c['library_ms']:.4f}", f"{c['bound_ms']:.4f}",
                     f"{c['flops'] / c['ms'] / 1e9:.0f} TFLOP/s"))
    _table("B6 bf16 (batch, H, W, Cin, Cout, stride; ms per launch; base "
           "in brackets)", rows,
           ["shape", "x", "ms (base)", "2nd runs", "cuDNN ms", "bound ms",
            "rate"])
    for batch in SERVE_BATCHES:
        def fwd(recs):
            return sum(r["ms"] * r["per_forward"] for r in recs
                       if r["key"][0] == batch)
        print(f"B6 per batch-{batch} forward: this {fwd(this['b6']):.4f} / "
              f"{fwd(this2['b6']):.4f} ms, base {fwd(base['b6']):.4f} / "
              f"{fwd(base2['b6']):.4f} ms")
    rows = [(",".join(map(str, r["key"])), r["bk"],
             f"{r['ms']:.4f}" + (" *" if r["chosen"] else ""))
            for r in this["b3_tiles"]]
    _table("B3 tile widths (* dx_tile's choice)", rows,
           ["shape", "BK", "ms"])
    rows = [(",".join(map(str, r["key"])),
             ("window" if r["window"] else "generic") + f" {r['bn']}",
             f"{r['ms']:.4f}" + (" *" if r["chosen"] else ""))
            for r in this["b6_tiles"]]
    _table("B6 kernels and tiles (* conv3x3_apply_tile's choice)", rows,
           ["shape", "kernel, BN", "ms"])
    import torch as _t
    bits = {}
    outs = [_t.load(os.path.join(OUT, f"conv_bn_ab_{i}_{tag}.json.b2.pt"))
            for i, (tag, _) in enumerate(runs)]
    for key in outs[0]:
        bits[key] = all(all(_t.equal(a, b) for a, b in zip(o[key],
                                                            outs[0][key]))
                        for o in outs[1:])
        print(f"B2 {key}: outputs equal bit for bit across the four runs: "
              f"{bits[key]}")
    summary = {"card": card, "b2_bit_equal": bits,
               "b3_per_step_ms": {
                   "this": per_path(this["b3"], "per_step"),
                   "base": per_path(base["b3"], "per_step")},
               "b6_b32_ms": {
                   "this": sum(r["ms"] * r["per_forward"] for r in
                               this["b6"] if r["key"][0] == 32),
                   "base": sum(r["ms"] * r["per_forward"] for r in
                               base["b6"] if r["key"][0] == 32)}}
    with open(os.path.join(OUT, "conv_bn_ab.json"), "w") as f:
        json.dump({"summary": summary, "runs": results}, f, indent=1)
    print(json.dumps(summary))
    return 0 if all(bits.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
