"""Example dispatcher: ``python -m analytics_zoo_tpu_torch.examples
<name> [args...]``; ``list`` (or no name) lists the examples."""

import ast
import importlib
import os
import sys

from analytics_zoo_tpu_torch.examples import EXAMPLES


def hook(main_file: str, name: str) -> str:
    """The first sentence of the docstring of the module ``name`` beside
    ``main_file``, read from its source (listing imports no module)."""
    path = os.path.join(os.path.dirname(main_file), name + ".py")
    with open(path) as f:
        doc = ast.get_docstring(ast.parse(f.read())) or ""
    first = " ".join(doc.split("\n\n")[0].split())
    first = first.split(". ")[0].rstrip(".")
    return first[:52] + ("…" if len(first) > 52 else "")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "list"):
        print("usage: python -m analytics_zoo_tpu_torch.examples "
              "<name> [args...]\n\nexamples:")
        for e in EXAMPLES:
            print(f"  {e:24s} {hook(__file__, e)}")
        return 0
    name = argv[0].replace("-", "_")
    if name not in EXAMPLES:
        print(f"unknown example {argv[0]!r}; run with 'list' to see "
              "available names", file=sys.stderr)
        return 2
    mod = importlib.import_module(f"analytics_zoo_tpu_torch.examples.{name}")
    ret = mod.main(argv[1:])
    # example mains return result payloads, not exit codes; only an
    # explicit int is a process status
    return ret if isinstance(ret, int) else 0


if __name__ == "__main__":
    sys.exit(main())
