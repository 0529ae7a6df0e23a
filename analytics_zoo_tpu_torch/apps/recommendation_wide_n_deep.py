"""Wide&Deep recommendation app (the reference's
``apps/recommendation-wide-n-deep``, its ``wide_n_deep.ipynb``): the
ml-1m workflow of feature assembly (the wide base and cross columns,
indicators, id embeddings, the continuous age), ``WideAndDeep`` trained
with Adam and ``class_nll``, then the ranking surfaces.

The recipe is ``examples/wide_and_deep.py`` (the reference's
``Ml1mWideAndDeep.scala``); this app drives it at tutorial scale with
every knob exposed.

    python -m analytics_zoo_tpu_torch.apps recommendation_wide_n_deep
    python -m analytics_zoo_tpu_torch.apps recommendation_wide_n_deep \\
        --device cpu --samples 1024 --users 50 --items 40
"""

from __future__ import annotations

import sys


def main(argv=None):
    from analytics_zoo_tpu_torch.examples.wide_and_deep import main as run
    return run(argv if argv is not None else sys.argv[1:])


if __name__ == "__main__":
    main()
