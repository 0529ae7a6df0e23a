#!/usr/bin/env python3
"""The shipped ``train_recompile_rate`` objective (more than 0.2 compiles
per second over 300 s, the window clipped to the engine's uptime) in a
fresh process: ``Estimator.train`` on bench.py's flagship step (s2d
stem, ``fused="defer"``, batch 128, ``mixed_bfloat16``, 6 steps, SGD 0.1
with momentum 0.9) with the SLO ticker at 1 s, in two child processes
one after the other: the first finds no library built and builds B1-B4
with ``nvcc`` in its first step, the second finds them built and only
loads them. In the port ``zoo_tpu_xla_compiles_total`` counts those
builds and loads (``common/diagnostics.py``).

Run from the repository root on a machine with one CUDA card:

    python3 scripts/cold_recompile_rule.py

Prints, per child: the compiles counted, the breaches of the rule, its
last state and value, the train wall seconds, and the card's name and
power limit; details go to ``chiprun_out/cold_recompile_rule.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, time
import numpy as np
import torch
import analytics_zoo_tpu_torch as zoo
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import slo
from analytics_zoo_tpu_torch.models.image.imageclassification import resnet50
from analytics_zoo_tpu_torch.ops.optimizers import SGD
zoo.init_nncontext(seed=0)
n = 6 * 128
gen = np.random.default_rng(0)
x = gen.random((n, 224, 224, 3), dtype=np.float32)
y = gen.integers(0, 1000, size=(n, 1)).astype(np.int32)
net = resnet50(input_shape=(224, 224, 3), classes=1000,
               space_to_depth=True, fused="defer")
net.init_params()
net.compile(optimizer=SGD(lr=0.1, momentum=0.9),
            loss="softmax_cross_entropy")
t0 = time.perf_counter()
net.fit(x, y, batch_size=128, nb_epoch=1)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
rule = {o["id"]: o for o in slo.get_engine().tick()["objectives"]}[
    "train_recompile_rate"]
snap = obs.snapshot()

def total(name, **labels):
    fam = snap.get(name, {"values": []})
    return sum(v["value"] for v in fam["values"]
               if all(v["labels"].get(k) == w for k, w in labels.items()))

print(json.dumps({
    "compiles": total("zoo_tpu_xla_compiles_total"),
    "breaches": total("zoo_tpu_slo_breaches_total",
                      slo="train_recompile_rate"),
    "state": rule["state"], "value": rule["value"],
    "ticks": slo.get_engine().status()["ticks"], "train_s": wall}))
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cold_recompile_rule: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    env = dict(os.environ, PYTHONPATH=ROOT, ZOO_TPU_SLO_TICK_S="1",
               ZOO_TPU_DTYPE_POLICY="mixed_bfloat16")
    out = {"card": card}
    for label in ("first process (builds B1-B4)",
                  "second process (loads them)"):
        run = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=900)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        out[label] = rec
        print(f"{label}: {rec['compiles']:g} compiles counted, "
              f"train_recompile_rate {rec['state']} at {rec['value']} per "
              f"second after {rec['ticks']} ticks, {rec['breaches']:g} "
              f"breaches; train {rec['train_s']:.2f} s on {card}",
              flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "cold_recompile_rule.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
