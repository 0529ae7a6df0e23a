#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``analytics_zoo_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises, so the
script exits non-zero and prints no result line:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: compiles the port's CUDA kernels from ``csrc/`` (one ``nvcc``
   per source, in parallel) and prints ptxas's registers and spills;
3. kernels: every distinct shape each kernel gets on ResNet-50's eval
   path at 224x224, batch 32, in f32 and bf16 (plus batch 1's M = 49
   and cases with the prologue on), held against its plain PyTorch
   version on the card, with kernel, plain, library-call and bound
   times;
4. main path: ``ImageClassifier("resnet-50", fused=True)`` at full
   width with seeded random weights and distinctive BatchNorm
   statistics, served by ``InferenceModel`` to requests from two
   threads at batch 1, 8 and 32 in f32 and bf16; checks the kernels'
   launch counts (36 and 16 per forward), the f32 logits against the
   port's unfused graph (cuDNN convs) and the bf16 logits against the
   f32 ones; times the median request at batch 1 and 32 (images/s) and
   profiles three batch-32 requests (device time by kernel, busy
   share);
5. a ``{"kernels": [...]}`` JSON line, then the card's name and power
   limit, then the result line ``{"ok": true, "device": {...}}``.

f32 comparisons run with TF32 off in both cuBLAS and cuDNN. Details go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
IMAGE = (224, 224, 3)
# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-3, "bfloat16": 2e-2}
KERNELS = {
    "matmul_bn_apply": {
        "source": "analytics_zoo_tpu_torch/csrc/matmul_bn_apply.cu",
        "replaces": "analytics_zoo_tpu/ops/conv_bn.py:747",
        "per_forward": 36},
    "conv3x3_bn_apply": {
        "source": "analytics_zoo_tpu_torch/csrc/conv3x3_bn_apply.cu",
        "replaces": "analytics_zoo_tpu/ops/conv_bn.py:1005",
        "per_forward": 16},
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def path_shapes(model, batch):
    """Distinct kernel shapes of one forward of a fused ResNet, each with
    its launch count: B5 keys (B, H, W, K, N, stride, residual, relu),
    B6 keys (B, H, W, Cin, Cout, stride)."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        FusedBottleneck
    b5, b6 = collections.Counter(), collections.Counter()
    for lyr in model.layers:
        if not isinstance(lyr, FusedBottleneck):
            continue
        h, w, c = lyr.input_shape
        f, s = lyr.filters, lyr.stride
        ho, wo = -(-h // s), -(-w // s)
        b5[(batch, h, w, c, f, 1, False, True)] += 1           # c1
        b6[(batch, h, w, f, f, s)] += 1                         # c2
        b5[(batch, ho, wo, f, 4 * f, 1, True, True)] += 1      # c3
        if lyr.downsample:
            b5[(batch, h, w, c, 4 * f, s, False, False)] += 1  # down
    return b5, b6


def kernel_cases(b5, b6):
    """(kernel, key, x dtype, weight dtype, prologue, launches per
    forward) for every main-path shape in both dtypes, plus batch 1's
    M = 49 and prologue cases (the main path runs none)."""
    cases = []
    for dt in ("float32", "bfloat16"):
        # the model keeps f32 weights: the 1x1 fold multiplies in the
        # weights' type, the 3x3 fold in the activations'
        cases += [("matmul_bn_apply", k, dt, "float32", False, n)
                  for k, n in sorted(b5.items())]
        cases += [("conv3x3_bn_apply", k, dt, dt, False, n)
                  for k, n in sorted(b6.items())]
        cases.append(("matmul_bn_apply", (1, 7, 7, 2048, 512, 1, False,
                                          True), dt, "float32", False, 0))
    cases.append(("matmul_bn_apply", (BATCH, 28, 28, 512, 128, 1, True,
                                      True), "bfloat16", "bfloat16",
                  True, 0))
    cases.append(("conv3x3_bn_apply", (BATCH, 28, 28, 128, 128, 1),
                  "bfloat16", "bfloat16", True, 0))
    return cases


def run_case(case, gen):
    """Kernel vs plain version on the card; returns the case's record."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    name, key, dt, wdt, prologue, per_fwd = case
    dev = torch.device("cuda")
    xdt, wdtype = getattr(torch, dt), getattr(torch, wdt)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)

    if name == "matmul_bn_apply":
        b, h, w, k, n, stride, has_res, relu = key
        ksize, cin, cout = 1, k, n
    else:
        b, h, w, cin, cout, stride = key
        ksize, has_res, relu = 3, False, True
    ho, wo = -(-h // stride), -(-w // stride)
    m = b * ho * wo
    x = randn(b, h, w, cin, dtype=xdt)
    wt = randn(ksize, ksize, cin, cout, scale=(ksize * ksize * cin) ** -0.5,
               dtype=wdtype)
    os_ = 1.0 + randn(cout, scale=0.1)
    ot = randn(cout, scale=0.1)
    s = 1.0 + randn(cin, scale=0.1) if prologue else None
    t = randn(cin, scale=0.1) if prologue else None
    res = randn(b, ho, wo, cout, dtype=xdt) if has_res else None
    fold = dict(in_scale=s, in_shift=t, relu_in=prologue, out_scale=os_,
                out_shift=ot, relu_out=relu)
    if name == "matmul_bn_apply":
        def kernel():
            return cb.conv1x1_bn_apply(x, wt, stride=stride, residual=res,
                                       **fold)
        x2 = x[:, ::stride, ::stride].reshape(m, k)
        w2 = wt[0, 0]

        def plain():
            return cb.matmul_bn_apply_ref(
                x[:, ::stride, ::stride].reshape(m, k), w2, s, t, os_, ot,
                None if res is None else res.reshape(m, n), prologue,
                prologue, relu).reshape(b, ho, wo, n)
        a_lib = x2.to(wdtype).contiguous()

        def library():
            return torch.matmul(a_lib, w2)
        flops = 2.0 * m * k * n
        nbytes = (m * k + m * n * (2 if has_res else 1)) * x.element_size() \
            + k * n * wt.element_size()
    else:
        def kernel():
            return cb.conv3x3_bn_apply(x, wt, stride=stride, **fold)

        def plain():
            return cb.conv3x3_bn_apply_ref(x, wt, s, t, os_, ot, prologue,
                                           prologue, relu, stride)
        pt, pb, _ = cb.tf_same_pads(h, 3, stride)
        pl, pr, _ = cb.tf_same_pads(w, 3, stride)
        xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous(
            memory_format=torch.channels_last)
        wl = wt.to(xdt).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(xp, wl, stride=stride)
        flops = 2.0 * m * 9 * cin * cout
        nbytes = (b * h * w * cin + m * cout) * x.element_size() + \
            9 * cin * cout * x.element_size()
    # the 1x1 fold multiplies in the weights' type, the 3x3 fold in x's
    peak = PEAK_FLOPS[wdt if name == "matmul_bn_apply" else dt]
    nbytes += 4 * 2 * (cout + (cin if prologue else 0))
    y, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(tuple(y.shape) == (b, ho, wo, cout) and y.dtype == xdt,
          f"{name} {key}: got {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y.float()).all()), f"{name} {key}: non-finite")
    err = (y.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    rec = {"kernel": name, "key": list(key), "dtype": dt, "w_dtype": wdt,
           "prologue": prologue, "per_forward": per_fwd,
           "max_abs_err": err, "tol": TOL[dt] * scale,
           "ms": time_ms(kernel), "plain_ms": time_ms(plain),
           "library_ms": time_ms(library),
           "flop_ms": flops / peak * 1e3, "byte_ms": nbytes / PEAK_BYTES * 1e3}
    rec["bound_ms"] = max(rec["flop_ms"], rec["byte_ms"])
    rec["bound_by"] = "operations" if rec["flop_ms"] > rec["byte_ms"] \
        else "bytes"
    print(f"  {name} {dt}/{wdt}{' prologue' if prologue else ''} "
          f"{tuple(key)} x{per_fwd}: max|err| {err:.3e} "
          f"(tol {rec['tol']:.3e}) kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})", flush=True)
    check(err <= rec["tol"], f"{name} {key} {dt}: max|err| {err} > "
          f"{rec['tol']}")
    return rec


def kernels_summary(records, launches):
    """Per kernel: its main-path launches, the worst error over every
    case, and each time summed over one batch-32 bf16 forward's
    launches (f32 beside it under ``by_dtype``)."""
    out = []
    for name, meta in KERNELS.items():
        recs = [r for r in records if r["kernel"] == name]
        by_dtype = {}
        for dt in ("bfloat16", "float32"):
            fwd = [r for r in recs if r["dtype"] == dt and r["per_forward"]]
            sums = {k: sum(r[k] * r["per_forward"] for r in fwd)
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "flop_ms", "byte_ms")}
            sums["bound_by"] = "operations" if \
                sums["flop_ms"] > sums["byte_ms"] else "bytes"
            by_dtype[dt] = sums
        head = by_dtype["bfloat16"]
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "launches_per_forward": meta["per_forward"],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "times_are": f"sum over one batch-{BATCH} bf16 forward",
            "by_dtype": by_dtype})
    return out


def main_path(card, detail):
    """Phase 4: serve ResNet-50 through the port's entry points."""
    import numpy as np
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier, convert_resnet_params)
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    ctx = zoo.init_nncontext(seed=0)
    check(ctx.device.type == "cuda", f"context device {ctx.device}")
    t0 = time.perf_counter()
    clf = ImageClassifier("resnet-50", input_shape=IMAGE, classes=1000,
                          fused=True)
    net = clf.model
    net.init_params()
    # distinctive BatchNorm statistics and affine params, so every fold
    # matters
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for pname, buf in net.named_buffers():
            n = buf.shape[0]
            if pname.endswith("moving_mean"):
                buf.copy_(torch.randn(n, generator=g) * 0.1)
            elif pname.endswith("moving_var"):
                buf.copy_(torch.rand(n, generator=g) + 0.5)
        for pname, p in net.named_parameters():
            if pname.endswith("gamma"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape[0], generator=g))
            elif pname.endswith("beta"):
                p.copy_(0.1 * torch.randn(p.shape[0], generator=g))
    im = InferenceModel(supported_concurrent_num=2).load_keras_net(net)
    print(f"  model built on {net.device} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rs = np.random.RandomState(0)
    images = {bs: rs.rand(bs, *IMAGE).astype(np.float32)
              for bs in (1, 8, BATCH)}
    requests = []
    for dt in (torch.float32, torch.bfloat16):
        for bs in (1, 8, BATCH):
            for rep in range(2):
                x = torch.from_numpy(images[bs]).to(ctx.device, dt)
                requests.append((dt, bs, rep, x))
    cb.reset_launches()
    torch.cuda.synchronize()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(im.predict, r[3]) for r in requests]
        outs = [f.result() for f in futures]
    torch.cuda.synchronize()
    launches = dict(cb.launches)
    n_fwd = len(requests)
    print(f"  answered {n_fwd} requests from 2 threads; launches "
          f"{launches}", flush=True)
    for name, meta in KERNELS.items():
        check(launches[name] == meta["per_forward"] * n_fwd,
              f"{name}: {launches[name]} launches for {n_fwd} forwards, "
              f"expected {meta['per_forward']} each")
    logits = {}
    for (dt, bs, rep, _), out in zip(requests, outs):
        check(out.shape == (bs, 1000) and np.isfinite(out).all(),
              f"bad logits {out.shape} for batch {bs} {dt}")
        logits[(dt, bs, rep)] = out

    # the port's unfused graph (cuDNN convs) on the same weights
    ref_clf = ImageClassifier("resnet-50", input_shape=IMAGE, classes=1000,
                              fused=False)
    ref = ref_clf.model
    ref.init_params()
    ref.load_params(convert_resnet_params(net.params(),
                                          params_to_numpy(ref)))
    checks = {}
    for bs in (1, 8, BATCH):
        want = ref.predict(images[bs], batch_size=BATCH)
        scale = max(1.0, float(np.abs(want).max()))
        for rep in range(2):
            got = logits[(torch.float32, bs, rep)]
            err = float(np.abs(got - want).max())
            checks[f"f32_vs_unfused_b{bs}_r{rep}"] = (err, 1e-3 * scale)
            f32 = logits[(torch.float32, bs, rep)]
            bf = logits[(torch.bfloat16, bs, rep)]
            err16 = float(np.abs(bf - f32).max())
            checks[f"bf16_vs_f32_b{bs}_r{rep}"] = (
                err16, 5e-2 * max(1.0, float(np.abs(f32).max())))
    for k, (err, tol) in checks.items():
        print(f"  {k}: max|err| {err:.4e} (tol {tol:.4e})", flush=True)
        check(err <= tol, f"{k}: {err} > {tol}")
    detail["logit_checks"] = checks

    rates, latency, profiles = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        for bs in (1, BATCH):
            x = torch.from_numpy(images[bs]).to(ctx.device, dt)
            med = median_request_s(im, x)
            latency[f"{dname}_b{bs}_ms"] = med * 1e3
            print(f"  {dname} batch {bs}: median {med * 1e3:.3f} ms per "
                  f"request, {bs / med:.1f} images/s on {card}",
                  flush=True)
        rates[dname] = BATCH / (latency[f"{dname}_b{BATCH}_ms"] / 1e3)
        profiles[dname] = profile_requests(im, x)
    detail["images_per_s"] = rates
    detail["request_ms"] = latency
    detail["profile"] = profiles
    return launches


def median_request_s(im, x, warmup: int = 3, iters: int = 10) -> float:
    """Median host time of one ``predict`` (input on the card, logits
    back on the host), after warm-up."""
    import torch
    for _ in range(warmup):
        im.predict(x)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        im.predict(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def profile_requests(im, x, n: int = 3) -> dict:
    """Device time by kernel over ``n`` requests (``torch.profiler``)
    and the device's busy share of the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            im.predict(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = collections.Counter()
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kernels[evt.key[:90]] += evt.self_device_time_total
    busy_us = sum(kernels.values())
    out = {"requests": n, "batch": int(x.shape[0]), "dtype": str(x.dtype),
           "wall_ms_per_request": wall_us / n / 1e3,
           "device_ms_per_request": busy_us / n / 1e3,
           "device_busy_share": busy_us / wall_us if busy_us else None,
           "top": [(k, v / n / 1e3) for k, v in kernels.most_common(8)]}
    print(f"  profile {out['dtype']} batch {out['batch']}: device busy "
          f"{out['device_ms_per_request']:.3f} of "
          f"{out['wall_ms_per_request']:.3f} ms per request", flush=True)
    for k, ms in out["top"]:
        print(f"    {ms:8.3f} ms  {k}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.ops import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    detail = {}

    print("[1] device", flush=True)
    card = card_line()
    print(card)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    detail["card"] = card

    print("[2] build", flush=True)
    t0 = time.perf_counter()
    built = cb.build_kernels()
    print(f"  built {built} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    detail["build_s"] = built
    for name in built:
        # nvcc -Xptxas=-v's report, kept beside each library
        with open(cuda_build.library_path(name) + ".log") as f:
            log = f.read()
        regs = sorted({int(r) for r in
                       re.findall(r"Used (\d+) registers", log)})
        spills = sum(int(b) for b in
                     re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: registers per thread {regs}, spill stores "
              f"{spills} bytes", flush=True)

    print("[3] kernels against their plain versions", flush=True)
    shapes_net = ImageClassifier("resnet-50", input_shape=IMAGE,
                                 classes=1000, fused=True).model
    shapes_net.init(torch.Generator().manual_seed(0))
    b5, b6 = path_shapes(shapes_net, BATCH)
    check(sum(b5.values()) == 36 and sum(b6.values()) == 16,
          f"ResNet-50 has {sum(b5.values())} 1x1 and {sum(b6.values())} "
          "3x3 folds per forward, expected 36 and 16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = [run_case(c, gen) for c in kernel_cases(b5, b6)]
    detail["kernel_cases"] = records
    del shapes_net

    print("[4] main path: ResNet-50 serving", flush=True)
    cb.reset_launches()
    launches = main_path(card, detail)

    print("[5] summary", flush=True)
    summary = kernels_summary(records, launches)
    detail["kernels"] = summary
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(detail, f, indent=1, default=str)
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
