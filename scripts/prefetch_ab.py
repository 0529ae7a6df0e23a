#!/usr/bin/env python3
"""The training input path's variants on the card, in turns: ResNet-50's
bf16 train step (``resnet50(fused=True)``, 224x224, batch 128, SGD 0.1
with momentum 0.9, the Estimator) with ``ZOO_TPU_PREFETCH`` 2 and 0, the
batch copied in f32 and cast on the card (the Estimator's placement) or
cast to bf16 on the host before its copy, and with the card cast at
depth 2 once more with PyTorch's CPU ops on one thread
(``torch.set_num_threads(1)``, so the worker's gather leaves the other
cores to the step's host work).

Run from the repository root on a machine with one CUDA card:

    python3 scripts/prefetch_ab.py [--windows 4]

Each variant starts from the same weights, takes one warm-up epoch of
five steps, then ``--windows`` timed epochs (host clock, ending in a
sync); the variants run in the order A B C D E E D C B A, so each is
timed twice, early and late. Prints, per variant, images/s (median, min and
max over its windows), the host ms the placement took per batch (in the
worker or in line), and the card's name and power limit; details go to
``chiprun_out/prefetch_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = (("prefetch 2, host cast", "2", "host", 0),
            ("prefetch 0, host cast", "0", "host", 0),
            ("prefetch 2, card cast", "2", "card", 0),
            ("prefetch 0, card cast", "0", "card", 0),
            ("prefetch 2, card cast, 1 CPU thread", "2", "card", 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=4)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prefetch_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        resnet50
    from analytics_zoo_tpu_torch.pipeline import estimator as em

    card = cs.card_line()
    ctx = zoo.init_nncontext(seed=0)
    rs = np.random.RandomState(0)
    n = cs.TRAIN_STEPS * cs.TRAIN_BATCH
    x = rs.rand(n, *cs.IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, size=(n, 1)).astype(np.int32)
    model = resnet50(input_shape=cs.IMAGE, classes=1000, fused=True)
    model.init_params()
    w0 = params_to_numpy(model)
    card_placer = em._CardPlacer
    place_s = []

    class Timed(card_placer):
        """The Estimator's placement (f32 into the ring and across, the
        cast on the card's stream), its host time per batch recorded."""

        def __call__(self, item):
            t = time.perf_counter()
            out = super().__call__(item)
            place_s.append(time.perf_counter() - t)
            return out

    class HostCast(Timed):
        """The design compared with: the inputs gathered into f32, then
        cast to bf16 on the host into the pinned ring (every NaN written
        as the card's 0x7FFF, so the cast is the card's bit for bit),
        half the bytes across; the labels as the Estimator places
        them."""

        def __init__(self, device, depth, float_dtype):
            super().__init__(device, depth, None)
            self.cast = float_dtype
            self.scratch = {}

        def _stage(self, key, src, idx, slot):
            if self.cast is None or key[0] != "x" or \
                    src.dtype != torch.float32:
                return super()._stage(key, src, idx, slot)
            n, row = idx.shape[0], tuple(src.shape[1:])
            ring = self._ring.get(key)
            if ring is None or ring[0].shape[0] < n:
                ring = self._ring[key] = [
                    torch.empty((n,) + row, dtype=self.cast,
                                pin_memory=True) for _ in range(self.slots)]
            part = self.scratch.get(key)
            if part is None or part.shape[0] < n:
                part = self.scratch[key] = torch.empty((n,) + row)
            part = torch.index_select(src, 0, idx, out=part[:n])
            out = ring[slot][:n].copy_(part)
            nan = torch.isnan(part)
            if bool(nan.any()):
                out.view(torch.int16)[nan] = 0x7FFF
            return out

    results = {v[0]: {"windows": [], "place_ms": [], "losses": []}
               for v in VARIANTS}
    threads = torch.get_num_threads()
    for name, depth, cast, one_thread in VARIANTS + VARIANTS[::-1]:
        os.environ["ZOO_TPU_PREFETCH"] = depth
        em._CardPlacer = HostCast if cast == "host" else Timed
        torch.set_num_threads(1 if one_thread else threads)
        try:
            model.load_params(w0)
            est = cs.train_estimator(ctx, model, "mixed_bfloat16")
            res = est.train(x, y, batch_size=cs.TRAIN_BATCH, nb_epoch=1)
            results[name]["losses"].append(res.history[-1]["losses"])
            place_s.clear()
            rates = cs.timed_epochs(est, x, y, opts.windows)["windows"]
        finally:
            em._CardPlacer = card_placer
            os.environ.pop("ZOO_TPU_PREFETCH", None)
            torch.set_num_threads(threads)
        results[name]["windows"] += rates
        results[name]["place_ms"].append(statistics.median(place_s) * 1e3)
        print(f"  {name}: images/s {[round(r, 1) for r in rates]}, "
              f"placement {results[name]['place_ms'][-1]:.2f} ms per batch",
              flush=True)
    for name, r in results.items():
        w = r["windows"]
        r.update(images_per_s=statistics.median(w), min=min(w), max=max(w))
        print(f"  {name}: {r['images_per_s']:.1f} images/s (median of "
              f"{len(w)} epochs; {r['min']:.1f}-{r['max']:.1f}), placement "
              f"{r['place_ms']} ms per batch on {card}", flush=True)
    same = all(r["losses"][0] == results[VARIANTS[0][0]]["losses"][0]
               for r in results.values())
    print(f"  first-epoch losses equal across variants: {same}", flush=True)
    print(card)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "prefetch_ab.json"),
              "w") as f:
        json.dump({"card": card, "results": results}, f, indent=1)
    print(json.dumps({k: v["images_per_s"] for k, v in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
