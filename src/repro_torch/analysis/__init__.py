"""Ownership analysis subsystem: static lint + runtime sanitizer + certifier
(the counterpart of ``repro.analysis``).

* ``linter`` — the AST borrow lint over the port's app-level surface
  (``src/repro_torch/apps/``, ``src/repro_torch/serve/``,
  ``src/repro_torch/core/sync.py``, ``examples/torch_*.py``), rules
  E101–E105.  CLI: ``PYTHONPATH=src python -m repro_torch.analysis.lint
  [--format=text|github|json]``.
* ``sanitizer`` — the TSan-style runtime checker enabled by
  ``Cluster(sanitize=True)`` (or ``REPRO_SANITIZE=1``); observation only.
* ``races`` — the trace-based coherence race certifier: it replays the
  sanitizer's event trace and proves every conflicting access ordered by
  an ownership edge.

See ``docs/analysis.md`` for the rule catalogue and the event model.
"""

from .linter import LintViolation, lint_file, lint_paths  # noqa: F401
from .races import RaceError, certify  # noqa: F401
from .sanitizer import Event, Sanitizer, SanitizerError  # noqa: F401
