#!/usr/bin/env python3
"""How often a ``torch.profiler`` window on the card records no device
activity at all, with Kineto's default CUPTI teardown after every
session and with CUPTI kept attached (``TEARDOWN_CUPTI=0``, what the card
tests' ``cuda`` fixture sets).

Run from the repository root on a machine with one CUDA card:

    python3 scripts/profiler_windows.py [--procs 8] [--windows 25]

For each setting, ``--procs`` fresh processes each open ``--windows``
profiler windows in turn, in the pattern of the card tests that read
which kernel a route reaches: each window holds one bf16 and one f32
launch of ``conv3x3_bn`` and ``matmul_bn_dw`` and a synchronize. A
window misses when a launched kernel's name is absent from its events.
Prints the misses per setting and a JSON line; details go to
``chiprun_out/profiler_windows.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(windows: int) -> dict:
    """Open ``windows`` profiler windows; count those that miss."""
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.ops import conv_bn as tcb
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(18)
    misses, empty = 0, 0
    for _ in range(windows):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(2, 8, 8, 64, generator=g).to(dev, dtype)
            w = (torch.randn(3, 3, 64, 64, generator=g) * 0.05).to(dev)
            sh = torch.zeros(64, device=dev)
            x2 = x.reshape(-1, 64)
            dy = torch.randn(128, 64, generator=g).to(dev, dtype)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tcb._conv3x3_bn_fwd(x, w, None, None, sh, False, False, 1)
                tcb._matmul_bn_dw(x2, None, None, None, sh, x2, dy, sh, sh,
                                  False, False)
                torch.cuda.synchronize()
            names = " ".join(e.key for e in prof.key_averages())
            want = ("conv3x3_bn", "matmul_bn_dw") if dtype == torch.bfloat16 \
                else ("conv_bn_f32_kernel", "conv_bn_dw_f32")
            if not all(n in names for n in want):
                misses += 1
                empty += "kernel" not in names
    return {"windows": 2 * windows, "misses": misses,
            "misses_without_any_kernel": empty}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--windows", type=int, default=25)
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device", file=sys.stderr)
        return 2
    if opts.child:
        print(json.dumps(child(opts.child)))
        return 0
    sys.path.insert(0, ROOT)
    from analytics_zoo_tpu_torch.ops import conv_bn as tcb
    from analytics_zoo_tpu_torch.ops import cuda_build
    cuda_build.build(list(tcb._SIGNATURES))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"card": card}
    for setting, env in (("default teardown", {}),
                         ("TEARDOWN_CUPTI=0", {"TEARDOWN_CUPTI": "0"})):
        runs = []
        for _ in range(opts.procs):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 str(opts.windows)], capture_output=True, text=True,
                env={**os.environ, **env}, check=True)
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        total = {k: sum(r[k] for r in runs) for k in runs[0]}
        out[setting] = {"total": total, "processes": runs}
        print(f"  {setting}: {total['misses']} of {total['windows']} windows "
              f"missed a kernel ({total['misses_without_any_kernel']} with "
              f"no kernel event at all)", flush=True)
    print(card)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profiler_windows.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v["total"] if isinstance(v, dict) else v
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
