#!/usr/bin/env python3
"""The flash-attention backward (B9 ``flash_bwd_dkdv``, B10
``flash_bwd_dq``) of the PyTorch/CUDA port on the card, one checkout
against another.

Run from the repository root on a machine with one CUDA card, with
another checkout (for example the parent commit, unpacked by
``git archive``) at DIR:

    python3 scripts/flash_ab.py --base DIR [--kernels bwd,e2e]

Four processes run in turn: the base checkout, this one, this one
again, the base again (each builds its own kernels from its ``csrc/``).
Each times, in device milliseconds per launch (CUDA events,
``chip_smoke.time_ms``):

- ``bwd`` (the default): B9 and B10 at every flash case of
  ``chip_smoke.flash_cases`` (both BERT routes' shapes in f32 and bf16,
  dead key tiles, causal, cross-length, dead-row and head-dim cases),
  on inputs made from a CPU generator seeded per case, so both
  checkouts see the same numbers; the outputs are saved and held
  against the first base run's within the kernels' tolerance, 1e-3
  (f32) or 2e-2 (bf16) of each output's own max|base| (the f32 bits
  change with the product's order);
- ``e2e``: the f32 BERT-base fine-tune step (chip_smoke phase 6's
  model and Estimator, batch 16, T 512, padding masks) through each
  checkout's entry points: five warm-up steps, then the mean wall ms of
  five steps twice, and the device ms per step and per kernel over two
  steps from ``torch.profiler`` (chip_smoke's ``profile_steps``).

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
    res = {"tree": tree, "bwd": [], "e2e": {}}
    saved = {}
    for i, case in enumerate(cs.flash_cases() if "bwd" in kernels else ()):
        args = case_inputs(cs, case, 100 + i)
        tag, b, tq, tk, h, d, causal, mkind, dt = case[:9]
        key = f"{tag} {dt} ({b}, {tq}, {tk}, {h}, {d})"
        for name in cs.BWD:
            got = fa._backward(name, *args)
            got = got if isinstance(got, tuple) else (got,)
            saved[f"{key} {name}"] = [t.cpu() for t in got]
            rec = {"case": key, "kernel": name, "dtype": dt,
                   "per_path": case[9][2 if name == "flash_bwd_dkdv"
                                       else 3],
                   "ms": cs.time_ms(lambda: fa._backward(name, *args))}
            if hasattr(fa, "bwd_route"):
                rec["route"] = fa.bwd_route(d, getattr(torch, dt))
            res["bwd"].append(rec)
            print(f"  {name} {key}: {rec['ms']:.4f} ms", flush=True)
        del args
        torch.cuda.empty_cache()
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
                    help="what to time, of bwd and e2e (default bwd)")
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
    if base["bwd"]:
        for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
            for dt in ("float32", "bfloat16"):
                rows = []
                for recs in zip(this["bwd"], this2["bwd"], base["bwd"],
                                base2["bwd"]):
                    t1, t2, b1, b2 = recs
                    if t1["kernel"] != name or t1["dtype"] != dt:
                        continue
                    rows.append([t1["case"], t1.get("route", ""),
                                 f"{t1['ms']:.4f} ({t2['ms']:.4f})",
                                 f"{b1['ms']:.4f} ({b2['ms']:.4f})",
                                 f"{t1['ms'] / b1['ms']:.2f}"])
                _table(f"{name} {dt}, device ms per launch, first run "
                       "(second)", rows,
                       ["case", "route", "this", "base", "this / base"])
        # per path: the f32 BERT step (12 launches each) and the bf16
        # bench step
        for label, recs in (("this", this["bwd"]), ("base", base["bwd"])):
            summary[f"{label}_f32_step_ms"] = sum(
                r["ms"] * r["per_path"] for r in recs
                if r["dtype"] == "float32")
            summary[f"{label}_bf16_step_ms"] = sum(
                r["ms"] * r["per_path"] for r in recs
                if r["dtype"] == "bfloat16")
        print(f"B9 + B10 per f32 BERT step: this "
              f"{summary['this_f32_step_ms']:.3f} ms, base "
              f"{summary['base_f32_step_ms']:.3f}; per bf16 bench step: "
              f"this {summary['this_bf16_step_ms']:.3f}, base "
              f"{summary['base_bf16_step_ms']:.3f}", flush=True)
    agree = {}
    worst = 0.0
    for key, ref in outs[0].items():
        tol = TOL["float32" if "float32" in key else "bfloat16"]
        for o in outs[1:]:
            for a, r in zip(o[key], ref):
                scale = r.float().abs().max().item()
                err = (a.float() - r.float()).abs().max().item()
                rel = err / scale if scale else err
                worst = max(worst, rel / tol)
                agree[key] = agree.get(key, True) and rel <= tol
    ok = all(agree.values())
    print(f"outputs within tolerance of the first base run's: {ok} (worst "
          f"error {worst:.3f} of its tolerance)", flush=True)
    summary["outputs_agree"] = ok
    if base["e2e"]:
        rows = [[k, f"{this['e2e'][k]:.3f} ({this2['e2e'][k]:.3f})",
                 f"{base['e2e'][k]:.3f} ({base2['e2e'][k]:.3f})"]
                for k in ("step_ms_0", "step_ms_1", "device_ms",
                          "wall_ms_profiled")]
        for g in this["e2e"]["by_kernel_ms"]:
            rows.append([f"device ms {g}",
                         f"{this['e2e']['by_kernel_ms'][g]:.3f}",
                         f"{base['e2e']['by_kernel_ms'].get(g, 0.0):.3f}"])
        _table("f32 BERT-base fine-tune step, ms (second run)", rows,
               ["metric", "this", "base"])
        summary["e2e"] = {"this": [this["e2e"], this2["e2e"]],
                          "base": [base["e2e"], base2["e2e"]]}
    with open(os.path.join(OUT, "flash_ab.json"), "w") as f:
        json.dump({"summary": summary, "runs": results}, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "e2e"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
