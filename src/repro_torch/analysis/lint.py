"""CLI: ``python -m repro_torch.analysis.lint [paths...] [--format=text|github|json]``.

With no paths, lints the port's app-level surface (``src/repro_torch/apps``,
``src/repro_torch/serve``, ``src/repro_torch/core/sync.py`` and the
port's examples, ``examples/torch_*.py``) resolved relative to the
repository root.  Exits 1 if any violation is reported.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .linter import lint_paths


def default_targets() -> list[Path]:
    # src/repro_torch/analysis/lint.py -> repo root is three parents above src/.
    root = Path(__file__).resolve().parents[3]
    port = root / "src" / "repro_torch"
    targets = [
        port / "apps",
        port / "serve",
        port / "core" / "sync.py",
        *sorted((root / "examples").glob("torch_*.py")),
    ]
    return [t for t in targets if t.exists()]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="AST borrow lint for the port's guard-API app surface.",
    )
    ap.add_argument("paths", nargs="*", help="files or directories (default: app surface)")
    ap.add_argument(
        "--format",
        choices=("text", "github", "json"),
        default="text",
        help="text (default), github (workflow annotations), or json",
    )
    args = ap.parse_args(argv)

    paths = [Path(p) for p in args.paths] or default_targets()
    violations = lint_paths(paths)

    if args.format == "json":
        print(
            json.dumps(
                [v.__dict__ for v in violations], indent=2, sort_keys=True
            )
        )
    else:
        for v in violations:
            print(v.format(args.format))
        n = len(violations)
        tail = f"{n} violation{'s' if n != 1 else ''}"
        print(f"repro_torch.analysis.lint: {tail} in {len(paths)} target(s)",
              file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
