"""App dispatcher: ``python -m analytics_zoo_tpu_torch.apps <name>
[args...]``; ``list`` (or no name) lists the apps."""

import importlib
import sys

from analytics_zoo_tpu_torch.apps import APPS
from analytics_zoo_tpu_torch.examples.__main__ import hook


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "list"):
        print("usage: python -m analytics_zoo_tpu_torch.apps "
              "<name> [args...]\n\napps:")
        for a in APPS:
            print(f"  {a:28s} {hook(__file__, a)}")
        return 0
    name = argv[0].replace("-", "_")
    if name not in APPS:
        print(f"unknown app {argv[0]!r}; run with 'list' to see "
              "available names", file=sys.stderr)
        return 2
    mod = importlib.import_module(f"analytics_zoo_tpu_torch.apps.{name}")
    ret = mod.main(argv[1:])
    # app mains return result payloads, not exit codes; only an
    # explicit int is a process status
    return ret if isinstance(ret, int) else 0


if __name__ == "__main__":
    sys.exit(main())
