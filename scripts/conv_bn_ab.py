#!/usr/bin/env python3
"""B1, B5, B3 and B6 of the PyTorch/CUDA port on the card, one checkout
against another, and B2's outputs compared bit for bit.

Run from the repository root on a machine with one CUDA card, with
another checkout (for example the parent commit, unpacked by
``git archive``) at DIR:

    python3 scripts/conv_bn_ab.py --base DIR [--kernels b1,b5,b3,b6,e2e]

Four processes run in turn: the base checkout, this one, this one
again, the base again (each builds its own kernels from its ``csrc/``).
Each times, in device milliseconds per launch (CUDA events,
``chip_smoke.time_ms``), the kernels ``--kernels`` names (default B1
and B5):

- B1, the bf16 1x1 with statistics (``_matmul_bn_fwd``), at ResNet-50's
  16 1x1 train-step shapes at batch 128, beside cuBLAS's ``x @ W`` on
  the same inputs and the shape's bound (bytes or bf16 operations), and
  the host's microseconds per call (the wrapper and the launch, timed
  on the host clock over calls that are not waited for);
- B5, the 1x1 fold with the model's f32 weights (``conv1x1_bn_apply``),
  at ResNet-50's 16 1x1 serving shapes at batch 1, 8 and 32 with bf16
  and f32 activations, beside cuBLAS's f32 ``x @ W`` (TF32 off) and the
  least time of an f32-accurate product, max(bytes / 3.35 TB/s,
  min(FLOP / 67 TFLOP/s, p FLOP / 495 TFLOP/s)), p the TF32 passes it
  needs (``chip_smoke.fold_passes``: 2 for a bf16 x, 3 for an f32 x),
  and the host's microseconds per call as for B1;
- B3, the bf16 dx kernel (``_matmul_bn_dx``), at the 16 train-step
  shapes, beside cuBLAS's ``dy @ W^T``;
- B6, the bf16 3x3 fold (``conv3x3_bn_apply``), at ResNet-50's 7 3x3
  serving shapes at batch 1, 8 and 32, beside cuDNN's conv;
- ``e2e`` (not in the default): ResNet-50 end to end through the
  checkout's entry points, the median bf16 serving request at batch 1
  and 32 (``InferenceModel.predict``, chip_smoke's
  ``median_request_s``) and the bf16 train step at batch 128
  (``Estimator.train``, two epochs of five steps timed after five
  warm-up steps), each beside its device time from ``torch.profiler``
  (chip_smoke's ``profile_requests`` and ``profile_train_steps``: three
  requests, three steps in one train call);

and saves B2's bf16 outputs (``_conv3x3_bn_fwd``: y and both
statistics) at six shapes that take each of its kernels and tiles. A
checkout that has the tile helpers (``fwd_tile``, ``dx_tile``,
``conv3x3_apply_tile``) also times every B1 tile width, every tile
width of B3 and every kernel and tile of B6 at each of those shapes,
each checked against its
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
import time

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


def host_us(fn, iters: int = 20) -> float:
    """Host microseconds per call of ``fn``, over ``iters`` calls that
    are not waited for (the card's queue holds them), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    spent = time.perf_counter() - t
    torch.cuda.synchronize()
    return spent / iters * 1e6


def end_to_end(cs) -> dict:
    """ResNet-50 through the checkout's entry points: the median bf16
    serving request at batch 1 and 32, and the bf16 train step at batch
    128 (module note)."""
    import numpy as np
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier, resnet50)
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    ctx = zoo.init_nncontext(seed=0)
    rs = np.random.RandomState(0)
    out = {}
    net = ImageClassifier("resnet-50", input_shape=cs.IMAGE, classes=1000,
                          fused=True).model
    net.init_params()
    im = InferenceModel().load_keras_net(net)
    for bs in (1, cs.BATCH):
        x = torch.from_numpy(rs.rand(bs, *cs.IMAGE).astype(np.float32)).to(
            ctx.device, torch.bfloat16)
        out[f"serve_bf16_b{bs}_ms"] = cs.median_request_s(
            im, x, iters=30)[0] * 1e3
        out[f"serve_bf16_b{bs}_device_ms"] = cs.profile_requests(
            im, x)["device_ms_per_step"]
    del im, net
    steps = 5
    model = resnet50(input_shape=cs.IMAGE, classes=1000, fused=True)
    model.init_params()
    est = Estimator(model, optimizer=SGD(lr=0.1, momentum=0.9),
                    loss="softmax_cross_entropy",
                    dtype_policy="mixed_bfloat16", ctx=ctx)
    x = rs.rand(steps * cs.TRAIN_BATCH, *cs.IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, size=(len(x), 1)).astype(np.int32)
    est.train(x, y, batch_size=cs.TRAIN_BATCH, nb_epoch=1)
    for epoch in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        est.train(x, y, batch_size=cs.TRAIN_BATCH, nb_epoch=1)
        torch.cuda.synchronize()
        out[f"train_bf16_step_ms_{epoch}"] = (time.perf_counter() - t) / \
            steps * 1e3
    out["train_bf16_device_ms"] = cs.profile_train_steps(
        est, x, y)["device_ms_per_step"]
    print(f"  end to end: {json.dumps(out)}", flush=True)
    return out


def child(tree: str, out: str, kernels) -> None:
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
    res = {"tree": tree, "b1": [], "b5": [], "b3": [], "b6": [],
           "b1_tiles": [], "b3_tiles": [], "b6_tiles": [], "e2e": {}}

    for key, per_step in sorted(b1.items()) if "b1" in kernels else ():
        b, h, w, k, n, stride, affine, has_r = key
        ho, wo = -(-h // stride), -(-w // stride)
        m = b * ho * wo
        x4 = randn(b, h, w, k, dtype=bf)
        wt = randn(k, n, scale=k ** -0.5, dtype=bf)
        s = 1.0 + randn(k, scale=0.1) if affine else None
        t = randn(k, scale=0.1) if affine else None
        sh = randn(n, scale=0.1)
        args = (x4, wt, s, t, None, sh, stride, bool(affine), bool(affine))
        x2 = x4[:, ::stride, ::stride].reshape(m, k).contiguous()
        nbytes = (m * k + m * n + k * n) * 2 + 4 * (2 * k * affine + 3 * n)
        flops = 2.0 * m * k * n
        rec = {"key": list(key), "per_step": per_step,
               "ms": cs.time_ms(lambda: cb._matmul_bn_fwd(*args)),
               "host_us": host_us(lambda: cb._matmul_bn_fwd(*args)),
               "library_ms": cs.time_ms(lambda: torch.matmul(x2, wt)),
               "bound_ms": max(flops / cs.PEAK_FLOPS["bfloat16"],
                               nbytes / cs.PEAK_BYTES) * 1e3,
               "bound_by": "operations" if flops / cs.PEAK_FLOPS[
                   "bfloat16"] > nbytes / cs.PEAK_BYTES else "bytes",
               "bytes": nbytes, "flops": flops}
        res["b1"].append(rec)
        print(f"  B1 {tuple(key)} x{per_step}: {rec['ms']:.4f} ms",
              flush=True)
        if hasattr(cb, "fwd_tile"):
            y, ssum, ssq = cb.matmul_bn_ref(x2, wt, s, t, None, sh,
                                            bool(affine), bool(affine))
            want = (y.reshape(b, ho, wo, n), ssum, ssq)
            chosen = cb.fwd_tile(n)
            real = cb.fwd_tile
            for bn in (256, 128, 64):
                if n % bn:
                    continue
                cb.fwd_tile = lambda *a_, bn=bn, **kw: bn
                try:
                    err, tol = err_tol(cb._matmul_bn_fwd(*args), want)
                    ms = cs.time_ms(lambda: cb._matmul_bn_fwd(*args))
                finally:
                    cb.fwd_tile = real
                res["b1_tiles"].append({
                    "key": list(key), "bn": bn, "chosen": bn == chosen,
                    "ms": ms, "max_abs_err": err, "tol": tol})
                if not err <= tol:
                    raise AssertionError(f"B1 {key} tile {bn}: {err} > "
                                         f"{tol}")
        del args, x4, x2
        torch.cuda.empty_cache()

    b5_counts = cs.path_shapes(net, 1)[0]
    for batch in SERVE_BATCHES if "b5" in kernels else ():
        for dt in (bf, torch.float32):
            for key1 in sorted(b5_counts):
                _, h, w, k, n, stride, has_res, relu = key1
                ho, wo = -(-h // stride), -(-w // stride)
                m = batch * ho * wo
                x4 = randn(batch, h, w, k, dtype=dt)
                wt = randn(k, n, scale=k ** -0.5)
                rr = randn(batch, ho, wo, n, dtype=dt) if has_res else None
                fold = dict(out_scale=1.0 + randn(n, scale=0.1),
                            out_shift=randn(n, scale=0.1), relu_out=relu)
                a_lib = x4[:, ::stride, ::stride].reshape(m, k).float() \
                    .contiguous()
                esize = x4.element_size()
                nbytes = (m * k + m * n * (2 if has_res else 1)) * esize + \
                    k * n * 4 + 4 * 2 * n
                flops = 2.0 * m * k * n
                passes = cs.fold_passes(str(dt).split(".")[-1], False)
                op_ms = min(flops / cs.PEAK_FLOPS["float32"],
                            passes * flops / cs.PEAK_TF32) * 1e3
                byte_ms = nbytes / cs.PEAK_BYTES * 1e3
                def fold_call():
                    return cb.conv1x1_bn_apply(x4, wt, stride=stride,
                                               residual=rr, **fold)
                rec = {"key": [batch] + list(key1[1:]),
                       "dtype": str(dt).split(".")[-1],
                       "per_forward": b5_counts[key1],
                       "ms": cs.time_ms(fold_call),
                       "host_us": host_us(fold_call),
                       "library_ms": cs.time_ms(
                           lambda: torch.matmul(a_lib, wt)),
                       "bound_ms": max(op_ms, byte_ms),
                       "bound_by": "operations" if op_ms > byte_ms
                       else "bytes", "bytes": nbytes, "flops": flops}
                res["b5"].append(rec)
                print(f"  B5 {tuple(rec['key'])} {rec['dtype']}: "
                      f"{rec['ms']:.4f} ms", flush=True)
                del x4, a_lib, rr
        torch.cuda.empty_cache()

    for key, per_step in sorted(b1.items()) if "b3" in kernels else ():
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
    for batch in SERVE_BATCHES if "b6" in kernels else ():
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

    if "e2e" in kernels:
        res["e2e"] = end_to_end(cs)
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
    ap.add_argument("--kernels", default="b1,b5",
                    help="what to time, of b1, b5, b3, b6 and e2e "
                         "(default b1,b5)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("conv_bn_ab: no CUDA device", file=sys.stderr)
        return 2
    kernels = set(opts.kernels.split(","))
    if opts.child:
        child(opts.child, opts.out, kernels)
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
                        "--child", tree, "--out", out, "--kernels",
                        opts.kernels], check=True)
        with open(out) as f:
            results.append(json.load(f))
    base, this, this2, base2 = results
    print(card)

    def per_path(recs, n_key):
        return sum(r["ms"] * r[n_key] for r in recs)

    def rate(c):
        return (f"{c['bytes'] / c['ms'] / 1e6:.0f} GB/s"
                if c["bound_by"] == "bytes"
                else f"{c['flops'] / c['ms'] / 1e9:.0f} TFLOP/s")

    def train_key(c):
        return (",".join(map(str, c["key"][1:6])) +
                (",a" if c["key"][6] else "") + (",r" if c["key"][7] else ""))

    summary = {"card": card}
    def host(c, p):
        return (f"{c['host_us']:.1f} ({p['host_us']:.1f})"
                if "host_us" in p else f"{c['host_us']:.1f}")

    def host_sum(recs, n_key, keep=lambda r: True):
        return sum(r["host_us"] * r[n_key] for r in recs
                   if "host_us" in r and keep(r)) / 1e3

    if base["b1"]:
        rows = [(train_key(c), c["per_step"],
                 f"{c['ms']:.4f} ({p['ms']:.4f})",
                 f"{c2['ms']:.4f} / {p2['ms']:.4f}",
                 f"{c['library_ms']:.4f}",
                 f"{c['bound_ms']:.4f} ({c['bound_by'][0]})", rate(c),
                 host(c, p))
                for p, c, c2, p2 in zip(base["b1"], this["b1"], this2["b1"],
                                        base2["b1"])]
        _table("B1 bf16, batch 128 (ms per launch; base in brackets; "
               "second runs this / base; host us per call)", rows,
               ["shape", "x", "ms (base)", "2nd runs", "cuBLAS ms",
                "bound ms", "rate", "host us (base)"])
        summary["b1_per_step_ms"] = {
            "this": [per_path(this["b1"], "per_step"),
                     per_path(this2["b1"], "per_step")],
            "base": [per_path(base["b1"], "per_step"),
                     per_path(base2["b1"], "per_step")],
            "cublas": sum(r["library_ms"] * r["per_step"]
                          for r in this["b1"]),
            "bound": sum(r["bound_ms"] * r["per_step"] for r in this["b1"]),
            "host_ms": {"this": [host_sum(this["b1"], "per_step"),
                                 host_sum(this2["b1"], "per_step")],
                        "base": [host_sum(base["b1"], "per_step"),
                                 host_sum(base2["b1"], "per_step")]}}
        print(f"B1 per step: {json.dumps(summary['b1_per_step_ms'])}")
        rows = [(",".join(map(str, r["key"][1:6])), r["bn"],
                 f"{r['ms']:.4f}" + (" *" if r["chosen"] else ""))
                for r in this["b1_tiles"]]
        _table("B1 tile widths (* fwd_tile's choice)", rows,
               ["shape", "BN", "ms"])
    if base["b5"]:
        rows = [(",".join(map(str, c["key"][:6])) +
                 (",res" if c["key"][6] else ""), c["dtype"],
                 c["per_forward"], f"{c['ms']:.4f} ({p['ms']:.4f})",
                 f"{c2['ms']:.4f} / {p2['ms']:.4f}",
                 f"{c['library_ms']:.4f}",
                 f"{c['bound_ms']:.4f} ({c['bound_by'][0]})", rate(c),
                 host(c, p))
                for p, c, c2, p2 in zip(base["b5"], this["b5"], this2["b5"],
                                        base2["b5"])]
        _table("B5 f32 weights (batch, H, W, K, N, stride; ms per launch; "
               "base in brackets; second runs this / base; host us per "
               "call)", rows,
               ["shape", "x", "per fwd", "ms (base)", "2nd runs",
                "cuBLAS f32 ms", "bound ms", "rate", "host us (base)"])
        fwd = {}
        for batch in SERVE_BATCHES:
            for dt in ("bfloat16", "float32"):
                def one(recs, batch=batch, dt=dt):
                    return sum(r["ms"] * r["per_forward"] for r in recs
                               if r["key"][0] == batch and r["dtype"] == dt)

                def hosts(recs, batch=batch, dt=dt):
                    return host_sum(recs, "per_forward", lambda r: r[
                        "key"][0] == batch and r["dtype"] == dt)
                fwd[f"{dt}_b{batch}"] = {
                    "this": [one(this["b5"]), one(this2["b5"])],
                    "base": [one(base["b5"]), one(base2["b5"])],
                    "host_ms": {"this": [hosts(this["b5"]),
                                         hosts(this2["b5"])],
                                "base": [hosts(base["b5"]),
                                         hosts(base2["b5"])]},
                    "cublas": sum(r["library_ms"] * r["per_forward"]
                                  for r in this["b5"] if r["key"][0] ==
                                  batch and r["dtype"] == dt),
                    "bound": sum(r["bound_ms"] * r["per_forward"]
                                 for r in this["b5"] if r["key"][0] ==
                                 batch and r["dtype"] == dt)}
                print(f"B5 per {dt} batch-{batch} forward: "
                      f"{json.dumps(fwd[f'{dt}_b{batch}'])}")
        summary["b5_per_forward_ms"] = fwd
    if base["b3"]:
        rows = [(train_key(c), c["per_step"],
                 f"{c['ms']:.4f} ({p['ms']:.4f})",
                 f"{c2['ms']:.4f} / {p2['ms']:.4f}",
                 f"{c['library_ms']:.4f}",
                 f"{c['bound_ms']:.4f} ({c['bound_by'][0]})", rate(c))
                for p, c, c2, p2 in zip(base["b3"], this["b3"], this2["b3"],
                                        base2["b3"])]
        _table("B3 bf16, batch 128 (ms per launch; base in brackets; "
               "second runs this / base)", rows,
               ["shape", "x", "ms (base)", "2nd runs", "cuBLAS ms",
                "bound ms", "rate"])
        summary["b3_per_step_ms"] = {
            "this": [per_path(this["b3"], "per_step"),
                     per_path(this2["b3"], "per_step")],
            "base": [per_path(base["b3"], "per_step"),
                     per_path(base2["b3"], "per_step")]}
        print(f"B3 per step: {json.dumps(summary['b3_per_step_ms'])}")
        rows = [(",".join(map(str, r["key"])), r["bk"],
                 f"{r['ms']:.4f}" + (" *" if r["chosen"] else ""))
                for r in this["b3_tiles"]]
        _table("B3 tile widths (* dx_tile's choice)", rows,
               ["shape", "BK", "ms"])
    if base["b6"]:
        rows = [(",".join(map(str, c["key"])), c["per_forward"],
                 f"{c['ms']:.4f} ({p['ms']:.4f})",
                 f"{c2['ms']:.4f} / {p2['ms']:.4f}",
                 f"{c['library_ms']:.4f}", f"{c['bound_ms']:.4f}",
                 f"{c['flops'] / c['ms'] / 1e9:.0f} TFLOP/s")
                for p, c, c2, p2 in zip(base["b6"], this["b6"], this2["b6"],
                                        base2["b6"])]
        _table("B6 bf16 (batch, H, W, Cin, Cout, stride; ms per launch; "
               "base in brackets)", rows,
               ["shape", "x", "ms (base)", "2nd runs", "cuDNN ms",
                "bound ms", "rate"])
        b6 = {}
        for batch in SERVE_BATCHES:
            def fwd(recs, batch=batch):
                return sum(r["ms"] * r["per_forward"] for r in recs
                           if r["key"][0] == batch)
            b6[f"b{batch}"] = {"this": [fwd(this["b6"]), fwd(this2["b6"])],
                               "base": [fwd(base["b6"]), fwd(base2["b6"])]}
            print(f"B6 per batch-{batch} forward: "
                  f"{json.dumps(b6[f'b{batch}'])}")
        summary["b6_per_forward_ms"] = b6
        rows = [(",".join(map(str, r["key"])),
                 ("window" if r["window"] else "generic") + f" {r['bn']}",
                 f"{r['ms']:.4f}" + (" *" if r["chosen"] else ""))
                for r in this["b6_tiles"]]
        _table("B6 kernels and tiles (* conv3x3_apply_tile's choice)", rows,
               ["shape", "kernel, BN", "ms"])
    if base["e2e"]:
        rows = [(k, f"{this['e2e'][k]:.3f} / {this2['e2e'][k]:.3f}",
                 f"{base['e2e'][k]:.3f} / {base2['e2e'][k]:.3f}")
                for k in this["e2e"]]
        _table("ResNet-50 end to end (ms; runs 2 / 3 of this, 1 / 4 of "
               "base)", rows, ["metric", "this", "base"])
        summary["e2e_ms"] = {k: {"this": [this["e2e"][k], this2["e2e"][k]],
                                 "base": [base["e2e"][k], base2["e2e"][k]]}
                             for k in this["e2e"]}
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
    summary["b2_bit_equal"] = bits
    with open(os.path.join(OUT, "conv_bn_ab.json"), "w") as f:
        json.dump({"summary": summary, "runs": results}, f, indent=1)
    print(json.dumps(summary))
    return 0 if all(bits.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
