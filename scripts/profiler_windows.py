#!/usr/bin/env python3
"""How often a short ``torch.profiler`` window on the card loses its
kernels over a long process, and where the kernels it keeps lie on the
host's clock.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/profiler_windows.py [--seconds 240]
    python3 scripts/profiler_windows.py --after-tests KIND [--teardown]

The process keeps CUPTI attached (``TEARDOWN_CUPTI=0``) unless
``--teardown`` is given and, for ``--seconds``, alternates half a
second of bf16 matmuls on the card with three windows in the pattern of the
card tests' route checks (one bf16 and one f32 launch of ``conv3x3_bn``
and ``matmul_bn_dw``, then a synchronize):

- tight: CUDA activity only, the window closed right after the
  synchronize (the card tests' window before this change);
- padded: CPU and CUDA activity, the window opened 0.1 s before the
  launches and closed 0.1 s after the synchronize;
- scheduled: the padded window after a warm-up step of the same
  session, whose results the profiler discards;
- lead: the padded window with a short spin kernel launched (and
  synchronized) before the calls (the card tests' ``_profiled_names``,
  which run with Kineto's default teardown).

``--after-tests KIND`` reproduces the card tests' process instead: one
padded window first (CUPTI attached, as the first route test attaches
it), then the card tests without their route tests
(``tests/test_torch_kernels_cuda.py``: thousands of launches outside
any window), then a window of KIND and four padded ones; it prints
which of them missed. ``--teardown`` leaves Kineto's default (CUPTI torn
down after each window) instead of ``TEARDOWN_CUPTI=0``.

A window misses when a launched kernel's name is absent from its events.
For each padded window it records the offset of the first kernel's start
from the first kernel launch call's start (microseconds, both as the
profiler reports them): a launch precedes its kernel, so an offset that
turns negative, or drifts by more than a tight window's slack, shows the
card's timestamps drifting from the host's. Prints the misses by kind and
by half of the run, the offsets' first, last, least and largest values,
and a JSON line; details go to ``chiprun_out/profiler_windows.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD_S = 0.1


def window(tcb, torch, dev, g, kind: str) -> dict:
    """One profiler window of ``kind`` over a bf16 and an f32 launch of
    each of two kernels: whether every kernel was recorded, and (padded
    kinds) the first kernel's offset from the first launch call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    calls = []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(2, 8, 8, 64, generator=g).to(dev, dtype)
        w = (torch.randn(3, 3, 64, 64, generator=g) * 0.05).to(dev)
        sh = torch.zeros(64, device=dev)
        x2 = x.reshape(-1, 64)
        dy = torch.randn(128, 64, generator=g).to(dev, dtype)
        calls.append((x, w, sh, x2, dy))

    def launch():
        for x, w, sh, x2, dy in calls:
            tcb._conv3x3_bn_fwd(x, w, None, None, sh, False, False, 1)
            tcb._matmul_bn_dw(x2, None, None, None, sh, x2, dy, sh, sh,
                              False, False)
        torch.cuda.synchronize()
    launch()   # the warm call the card tests make
    padded = kind != "tight"
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if padded else [])
    sched = (schedule(wait=0, warmup=1, active=1, repeat=1)
             if kind == "scheduled" else None)
    with profile(activities=acts, schedule=sched) as prof:
        if sched is not None:
            launch()
            prof.step()
        if padded:
            time.sleep(PAD_S)
        if kind == "lead":
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        launch()
        if padded:
            time.sleep(PAD_S)
        if sched is not None:
            prof.step()
    names = " ".join(e.key for e in prof.key_averages())
    want = ("conv3x3_bn", "matmul_bn_dw", "conv_bn_f32_kernel",
            "conv_bn_dw_f32")
    out = {"miss": not all(n in names for n in want),
           "no_kernel": "kernel" not in names,
           "buffer_request": "Activity Buffer Request" in names}
    if padded:
        events = prof.events()
        kern = [e.time_range.start for e in events
                if e.device_type == DeviceType.CUDA and "kernel" in e.name]
        launch_calls = [e.time_range.start for e in events
                        if e.device_type == DeviceType.CPU and
                        "LaunchKernel" in e.name]
        out["offset_us"] = (min(kern) - min(launch_calls)
                            if kern and launch_calls else None)
    return out


KINDS = ("tight", "padded", "scheduled", "lead")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--after-tests", choices=KINDS)
    ap.add_argument("--teardown", action="store_true")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device", file=sys.stderr)
        return 2
    if not opts.teardown:
        os.environ["TEARDOWN_CUPTI"] = "0"
    sys.path.insert(0, ROOT)
    from analytics_zoo_tpu_torch.ops import conv_bn as tcb
    tcb.build_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(18)
    summary = {"card": card}
    if opts.after_tests:
        import pytest
        attach = window(tcb, torch, dev, g, "padded")
        rc = pytest.main([os.path.join(ROOT, "tests",
                                       "test_torch_kernels_cuda.py"),
                          "-q", "-p", "no:cacheprovider", "--noconftest",
                          "-k", "not reach_the_kernels and not wgmma_kernels"
                          " and not templates"])
        after = [window(tcb, torch, dev, g, k)
                 for k in [opts.after_tests] + ["padded"] * 4]
        summary.update(kind=opts.after_tests, teardown=opts.teardown,
                       tests_rc=int(rc), attach=attach, after=after)
        mode = "teardown" if opts.teardown else "TEARDOWN_CUPTI=0"
        print(f"  after the card tests ({mode}): first window "
              f"{opts.after_tests} "
              f"{after[0]}; then padded {after[1:]} (the attaching "
              f"window: {attach})", flush=True)
        print(card)
        print(json.dumps(summary))
        return 0
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    rows = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < opts.seconds:
        t = time.perf_counter()
        while time.perf_counter() - t < 0.5:
            b = a @ a
            torch.cuda.synchronize()
        del b
        row = {"t_s": time.perf_counter() - t0}
        for kind in KINDS:
            row[kind] = window(tcb, torch, dev, g, kind)
        rows.append(row)
    half = len(rows) // 2
    summary["windows_each"] = len(rows)
    for kind in KINDS:
        summary[kind] = {
            "misses": sum(r[kind]["miss"] for r in rows),
            "misses_first_half": sum(r[kind]["miss"] for r in rows[:half]),
            "misses_second_half": sum(r[kind]["miss"] for r in rows[half:]),
            "without_any_kernel": sum(r[kind]["no_kernel"] for r in rows)}
    offs = [r[k]["offset_us"] for r in rows for k in KINDS[1:]
            if r[k].get("offset_us") is not None]
    if offs:
        summary["offset_us"] = {"first": offs[:3], "last": offs[-3:],
                                "min": min(offs), "max": max(offs),
                                "n": len(offs)}
    for kind in KINDS:
        s = summary[kind]
        print(f"  {kind}: {s['misses']} of {len(rows)} windows missed a "
              f"kernel ({s['misses_first_half']} in the first half, "
              f"{s['misses_second_half']} in the second; "
              f"{s['without_any_kernel']} with no kernel at all)",
              flush=True)
    if offs:
        o = summary["offset_us"]
        print(f"  first kernel after its launch call (us): first "
              f"{o['first']}, last {o['last']}, least {o['min']}, largest "
              f"{o['max']} over {o['n']} windows", flush=True)
    print(card)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profiler_windows.json"),
              "w") as f:
        json.dump({"summary": summary, "rows": rows}, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
