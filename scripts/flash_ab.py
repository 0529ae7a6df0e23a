#!/usr/bin/env python3
"""The flash-attention kernels of the PyTorch/CUDA port on the card, one
checkout against another: the backward (B9 ``flash_bwd_dkdv``, B10
``flash_bwd_dq``), the forward (B7 ``flash_fwd``, B8 ``flash_block``)
and the decode kernel (B11 ``flash_decode``).

Run from the repository root on a machine with one CUDA card, with
another checkout (for example the parent commit, unpacked by
``git archive``) at DIR:

    python3 scripts/flash_ab.py --base DIR [--kernels bwd,fwd,e2e]
    python3 scripts/flash_ab.py --base DIR --kernels decode,gen

Four processes run in turn: the base checkout, this one, this one
again, the base again (each builds its own kernels from its ``csrc/``).
Each times, in device milliseconds per launch (CUDA events,
``chip_smoke.time_ms``):

- ``bwd`` (the default) and ``fwd``: B9 and B10, or B7 and B8, at every
  flash case of ``chip_smoke.flash_cases`` (both BERT routes' shapes in
  f32 and bf16, dead key tiles, causal, cross-length, dead-row and
  head-dim cases), on inputs made from a CPU generator seeded per case,
  so both checkouts see the same numbers; the outputs are saved and
  held against the first base run's within the kernels' tolerance,
  1e-3 (f32) or 2e-2 (bf16) of each output's own max|base| (the f32
  bits change with the product's order; a row max of -1e30 must match
  exactly);
- ``decode``: B11 at every decode case of ``chip_smoke.decode_cases``
  through the dense entry ``flash_decode_attention``, which both
  checkouts have (for a paged case on the view gathered through its
  table), inputs from a CPU generator seeded per case; and at the paged
  cases the route the decode step takes (``decode_route``): this
  checkout's paged entry where it has one, else the gathers of K and V
  (and int8 scales) plus the dense entry. Outputs are held against the
  first base run's as above;
- ``gen``: chip_smoke phase 8's engine (GPT-1's widths, T 2048, 8 slots,
  seeded random weights) through each checkout's entry points: tokens/s
  and the median time to first token of the served traffic, the decode
  step at 8 active slots (median host ms of 30) and its profiled device
  ms per step with the B11 and page-table-gather rows;
- ``e2e``: the f32 BERT-base fine-tune step and evaluate batch
  (chip_smoke phase 6's model and Estimator, batch 16, T 512, padding
  masks) through each checkout's entry points: five warm-up steps, then
  the mean wall ms of five steps twice and of five evaluate batches, and
  the device ms per step or batch and per kernel over two of them from
  ``torch.profiler`` (chip_smoke's ``profile_steps``).

The script prints a table per kernel and dtype (each checkout's first
run, its second beside it as the spread), the agreement of the outputs
and a JSON line; the details go to ``chiprun_out/flash_ab.json``.
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
TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def case_inputs(cs, case, seed):
    """B9/B10's inputs at one chip_smoke flash case, from a CPU
    generator (the same numbers in every checkout) moved to the card,
    with the plain forward's row statistics."""
    import torch

    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    tag, b, tq, tk, h, d, causal, mkind, dt, _, strided = case
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    xdt = getattr(torch, dt)

    def randn(*shape):
        return (torch.randn(*shape, generator=g) * 0.5).to(dev, xdt)
    if strided:
        qkv = randn(b, tq, 3 * h * d)
        q, k, v = [t.reshape(b, tq, h, d) for t in qkv.split(h * d, -1)]
    else:
        q, k, v = randn(b, tq, h, d), randn(b, tk, h, d), randn(b, tk, h, d)
    dout = randn(b, tq, h, d)
    km = cs._key_mask(b, tk, mkind, dev)
    scale = d ** -0.5
    off = tk - tq
    _, m, l = fa.flash_block_ref(q, k, v, km, causal, scale, off)
    out = fa.flash_fwd_ref(q, k, v, km, causal, scale)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, dout, km, m, l, delta, causal, scale, off)


def decode_part(cs, fa, saved) -> list:
    """B11 at every decode case (module note): ms per launch through the
    dense entry and, at the paged cases, along the decode step's
    route."""
    import torch

    from analytics_zoo_tpu_torch.ops import kv_cache as kvc
    recs = []
    for i, case in enumerate(cs.decode_cases()):
        tag, s, t, h, d, dt, lens, int8, per_path, paged = case
        g = torch.Generator().manual_seed(200 + i)
        xdt = getattr(torch, dt)

        def randn(*shape):
            return (torch.randn(*shape, generator=g) * 0.5).to("cuda", xdt)
        x = cs.decode_inputs(case, randn)
        q, dk, dv, km, dkw = x["dense"]
        scale = x["scale"]
        fns = {"dense": lambda: fa.flash_decode_attention(
            q, dk, dv, km, scale, **dkw)}
        if paged and hasattr(fa, "flash_decode_paged"):
            fns["route"] = lambda: fa.flash_decode_paged(
                q, x["k"], x["v"], x["table"], x["lens"], scale,
                **x["scales"])
        elif paged:
            def gathered():
                k = kvc.gather_layer(x["k"], x["table"], t)
                v = kvc.gather_layer(x["v"], x["table"], t)
                sc = {n: kvc.gather_layer(y, x["table"], t)
                      for n, y in x["scales"].items()}
                return fa.flash_decode_attention(q, k, v, km, scale, **sc)
            fns["route"] = gathered
        key = f"{tag} {dt} ({s}, {t}, {h}, {d}{', int8' if int8 else ''})"
        for how, fn in fns.items():
            saved[f"{key} {how} flash_decode_{how}"] = [fn().cpu()]
            rec = {"case": key, "kernel": f"flash_decode_{how}",
                   "dtype": dt, "per_path": per_path, "ms": cs.time_ms(fn)}
            recs.append(rec)
            print(f"  flash_decode {how} {key}: {rec['ms']:.4f} ms",
                  flush=True)
        del x, fns, q, dk, dv
        torch.cuda.empty_cache()
    return recs


def generation(cs) -> dict:
    """chip_smoke phase 8's engine and traffic through the checkout's
    entry points (module note)."""
    import torch
    card = cs.card_line()
    _, eng, _ = cs.gen_engine()
    served = cs.serve_generation(eng)
    stepped = cs.decode_step_profile(eng, card)
    by = stepped["profile"]["ms_per_step_by_kernel"]
    out = {"tokens_per_s": served["tokens_per_s"],
           "ttft_median_ms": served["ttft_median_ms"],
           "step_ms": stepped["step_ms_8_slots"],
           "device_ms": stepped["profile"]["device_ms_per_step"],
           "gathers_ms": by.get("page-table gathers", 0.0),
           "b11_ms": by.get("flash_decode (B11)", 0.0),
           "by_kernel_ms": by}
    print(f"  generation: {json.dumps(out)}", flush=True)
    del eng
    torch.cuda.empty_cache()
    return out


def end_to_end(cs) -> dict:
    """The f32 BERT-base fine-tune step through the checkout's entry
    points (module note)."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.ops.optimizers import Adam, warmup
    from analytics_zoo_tpu_torch.pipeline.estimator import (
        Estimator, MaxIteration)

    ctx = zoo.init_nncontext(seed=0)
    n = cs.BERT_STEPS * cs.BERT_BATCH
    x, y = cs.bert_batch(n, cs.BERT_T, cs.BERT["vocab"])
    model = cs.finetune_model()
    model.init_params()
    est = Estimator(model, optimizer=Adam(lr=warmup(5e-5, 8, delta=(
        5e-4 - 5e-5) / 8)), loss="sparse_categorical_crossentropy",
        metrics=["accuracy"], ctx=ctx)
    est.train(x, y, batch_size=cs.BERT_BATCH, nb_epoch=1)
    out = {}
    for epoch in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        est.train(x, y, batch_size=cs.BERT_BATCH, nb_epoch=1)
        torch.cuda.synchronize()
        out[f"step_ms_{epoch}"] = (time.perf_counter() - t) / \
            cs.BERT_STEPS * 1e3
    prof = cs.profile_steps(
        lambda: est.train([a[:cs.BERT_BATCH] for a in x],
                          y[:cs.BERT_BATCH], batch_size=cs.BERT_BATCH,
                          end_trigger=MaxIteration(est.step + 1)),
        2, cs.FLASH_KERNEL_NAMES)
    out["device_ms"] = prof["device_ms_per_step"]
    out["wall_ms_profiled"] = prof["wall_ms_per_step"]
    out["by_kernel_ms"] = prof["ms_per_step_by_kernel"]

    def evaluate():
        est.evaluate([a[:cs.BERT_BATCH] for a in x], y[:cs.BERT_BATCH],
                     batch_size=cs.BERT_BATCH)
    evaluate()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(cs.BERT_STEPS):
        evaluate()
    torch.cuda.synchronize()
    out["eval_ms"] = (time.perf_counter() - t) / cs.BERT_STEPS * 1e3
    prof = cs.profile_steps(evaluate, 2, cs.FLASH_KERNEL_NAMES)
    out["eval_device_ms"] = prof["device_ms_per_step"]
    out["eval_by_kernel_ms"] = prof["ms_per_step_by_kernel"]
    print(f"  end to end: {json.dumps(out)}", flush=True)
    return out


def child(tree: str, out: str, kernels) -> None:
    """Time and save one checkout's kernels (see the module note)."""
    sys.path.insert(0, tree)
    import torch

    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    if not os.path.abspath(fa.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {fa.__file__}, not from {tree}")
    cs = _chip_smoke()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.build_kernels()
    res = {"tree": tree, "bwd": [], "fwd": [], "decode": [], "e2e": {},
           "gen": {}}
    saved = {}
    names = [n for part, ns in (("fwd", cs.FWD), ("bwd", cs.BWD))
             if part in kernels for n in ns]
    for i, case in enumerate(cs.flash_cases() if names else ()):
        args = case_inputs(cs, case, 100 + i)
        q, k, v, _, km, _, _, _, causal, scale, off = args
        tag, b, tq, tk, h, d, causal, mkind, dt = case[:9]
        key = f"{tag} {dt} ({b}, {tq}, {tk}, {h}, {d})"
        for name in names:
            if name == "flash_fwd":
                def fn():
                    return fa._flash_fwd(q, k, v, km, causal, scale)
            elif name == "flash_block":
                def fn():
                    return fa._block_partials(q, k, v, off, causal, scale,
                                              km)
            else:
                def fn(name=name):
                    return fa._backward(name, *args)
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            saved[f"{key} {name}"] = [t.cpu() for t in got]
            part = "fwd" if name in cs.FWD else "bwd"
            rec = {"case": key, "kernel": name, "dtype": dt,
                   "per_path": case[9][cs.FLASH.index(name)],
                   "ms": cs.time_ms(fn)}
            route = getattr(fa, part + "_route", None)
            if route is not None:
                rec["route"] = route(d, getattr(torch, dt))
            res[part].append(rec)
            print(f"  {name} {key}: {rec['ms']:.4f} ms", flush=True)
        del args, q, k, v
        torch.cuda.empty_cache()
    if "decode" in kernels:
        res["decode"] = decode_part(cs, fa, saved)
    if "gen" in kernels:
        res["gen"] = generation(cs)
    if "e2e" in kernels:
        res["e2e"] = end_to_end(cs)
    torch.save(saved, out + ".outs.pt")
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
    ap.add_argument("--kernels", default="bwd",
                    help="what to time, of bwd, fwd, decode, gen and e2e "
                         "(default bwd)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
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
    results, outs = [], []
    for i, (tag, tree) in enumerate(runs):
        out = os.path.join(OUT, f"flash_ab_{i}_{tag}.json")
        print(f"[run {i}: {tag} {tree}]", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--child", tree, "--out", out, "--kernels",
                        opts.kernels], check=True)
        with open(out) as f:
            results.append(json.load(f))
        outs.append(torch.load(out + ".outs.pt"))
        os.remove(out + ".outs.pt")   # hundreds of MB at BERT's shape
    base, this, this2, base2 = results
    print(card)
    summary = {"card": card}
    cs = _chip_smoke()
    for part, names in (("fwd", cs.FWD), ("bwd", cs.BWD)):
        if not base[part]:
            continue
        for name in names:
            for dt in ("float32", "bfloat16"):
                rows = []
                for t1, t2, b1, b2 in zip(this[part], this2[part],
                                          base[part], base2[part]):
                    if t1["kernel"] != name or t1["dtype"] != dt:
                        continue
                    rows.append([t1["case"], t1.get("route", ""),
                                 f"{t1['ms']:.4f} ({t2['ms']:.4f})",
                                 f"{b1['ms']:.4f} ({b2['ms']:.4f})",
                                 f"{t1['ms'] / b1['ms']:.2f}"])
                _table(f"{name} {dt}, device ms per launch, first run "
                       "(second)", rows,
                       ["case", "route", "this", "base", "this / base"])
        # per path: the f32 BERT step or eval batch, the bf16 bench step
        for label, recs in (("this", this[part]), ("base", base[part])):
            for name in names:
                for dt, tag in (("float32", "f32"), ("bfloat16", "bf16")):
                    summary[f"{label}_{name}_{tag}_path_ms"] = sum(
                        r["ms"] * r["per_path"] for r in recs
                        if r["dtype"] == dt and r["kernel"] == name)
        for name in names:
            print(f"{name} per path (f32 BERT step or eval batch; bf16 "
                  f"bench step): this "
                  f"{summary[f'this_{name}_f32_path_ms']:.3f} ms, base "
                  f"{summary[f'base_{name}_f32_path_ms']:.3f}; bf16: this "
                  f"{summary[f'this_{name}_bf16_path_ms']:.3f}, base "
                  f"{summary[f'base_{name}_bf16_path_ms']:.3f}", flush=True)
    if base["decode"]:
        for how in ("dense", "route"):
            for dt in ("float32", "bfloat16"):
                rows = [[t1["case"], f"{t1['ms']:.4f} ({t2['ms']:.4f})",
                         f"{b1['ms']:.4f} ({b2['ms']:.4f})",
                         f"{t1['ms'] / b1['ms']:.2f}"]
                        for t1, t2, b1, b2 in zip(
                            this["decode"], this2["decode"], base["decode"],
                            base2["decode"])
                        if t1["kernel"] == f"flash_decode_{how}" and
                        t1["dtype"] == dt]
                if rows:
                    _table(f"flash_decode {how} {dt}, device ms per launch, "
                           "first run (second)", rows,
                           ["case", "this", "base", "this / base"])
        for label, recs in (("this", this["decode"]),
                            ("base", base["decode"])):
            summary[f"{label}_flash_decode_route_f32_step_ms"] = sum(
                r["ms"] * r["per_path"] for r in recs
                if r["kernel"] == "flash_decode_route")
    if base["gen"]:
        keys = ("step_ms", "device_ms", "gathers_ms", "b11_ms",
                "tokens_per_s", "ttft_median_ms")
        _table("generation: decode step at 8 slots (host ms, profiled "
               "device ms and its rows), tokens/s, median TTFT ms (second "
               "run)", [[k, f"{this['gen'][k]:.3f} ({this2['gen'][k]:.3f})",
                         f"{base['gen'][k]:.3f} ({base2['gen'][k]:.3f})"]
                        for k in keys], ["metric", "this", "base"])
        summary["gen"] = {"this": [this["gen"], this2["gen"]],
                          "base": [base["gen"], base2["gen"]]}
    agree = {}
    worst = 0.0
    bitwise = {}    # kernel -> every output of every case equal bit for bit
    for key, ref in outs[0].items():
        tol = TOL["float32" if "float32" in key else "bfloat16"]
        kernel = key.rsplit(" ", 1)[1]
        for o in outs[1:]:
            bitwise[kernel] = bitwise.get(kernel, True) and all(
                torch.equal(a, r) for a, r in zip(o[key], ref))
            for a, r in zip(o[key], ref):
                a, r = a.float(), r.float()
                dead = r.abs() >= 1e29      # a row max of -1e30: exact
                same = torch.equal(a[dead], r[dead])
                a, r = a[~dead], r[~dead]
                scale = r.abs().max().item() if r.numel() else 0.0
                err = (a - r).abs().max().item() if r.numel() else 0.0
                rel = err / scale if scale else err
                worst = max(worst, rel / tol)
                agree[key] = agree.get(key, True) and rel <= tol and same
    ok = all(agree.values())
    print(f"outputs within tolerance of the first base run's: {ok} (worst "
          f"error {worst:.3f} of its tolerance)", flush=True)
    summary["outputs_agree"] = ok
    summary["bit_for_bit_with_base"] = bitwise
    print(f"outputs equal to the first base run's bit for bit, by kernel: "
          f"{bitwise}", flush=True)
    if base["e2e"]:
        rows = [[k, f"{this['e2e'][k]:.3f} ({this2['e2e'][k]:.3f})",
                 f"{base['e2e'][k]:.3f} ({base2['e2e'][k]:.3f})"]
                for k in ("step_ms_0", "step_ms_1", "device_ms",
                          "wall_ms_profiled", "eval_ms", "eval_device_ms")]
        for by, label in (("by_kernel_ms", "step"),
                          ("eval_by_kernel_ms", "eval")):
            for g in this["e2e"][by]:
                rows.append([f"{label} device ms {g}",
                             f"{this['e2e'][by][g]:.3f}",
                             f"{base['e2e'][by].get(g, 0.0):.3f}"])
        _table("f32 BERT-base fine-tune step and evaluate batch, ms "
               "(second run)", rows, ["metric", "this", "base"])
        summary["e2e"] = {"this": [this["e2e"], this2["e2e"]],
                          "base": [base["e2e"], base2["e2e"]]}
    with open(os.path.join(OUT, "flash_ab.json"), "w") as f:
        json.dump({"summary": summary, "runs": results}, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("e2e", "gen")}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
