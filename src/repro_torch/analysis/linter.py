"""AST borrow lint for the guard-API app surface.

The old CI check was a grep for ``borrow()``/``deref()``/``drop()`` call
pairs — blind to aliasing, strings, comments, and method-name collisions.
This module parses the app-level surface with :mod:`ast` and reports the
violations a grep cannot see.  Rules (codes are stable; names are used in
``# lint: allow(<name>)`` suppressions):

========  ====================  ==================================================
code      name                  what it catches
========  ====================  ==================================================
E101      raw-verb              raw protocol-verb calls (``borrow``/``borrow_mut``/
                                ``deref``/``deref_mut``/``drop_ref``, and bare
                                ``.drop(th[, h])``) outside ``core/`` — the guard
                                API is the app surface
E102      escaping-payload      a guard payload (the ``with ... as v`` name, or an
                                alias derived from it) read after its ``with``
                                block closed — the payload may be stale or remote
E103      guard-live-conflict   ``transfer``/``drop``/``free``/``drop_box`` on a
                                handle while a guard on that same handle is
                                syntactically live (inside its ``with`` body)
E104      guard-no-with         a guard opened without ``with`` — a direct
                                ``ReadGuard``/``WriteGuard``/``Region``
                                construction, an explicit ``.__enter__()``, or a
                                ``h.read(th)``/``h.write(th)`` call whose result
                                is not a ``with`` context (no structural release
                                on exception)
E105      spawn-capture         a DSM handle captured by a ``scheduler.spawn``
                                closure without ``server=`` routing — use
                                ``spawn_near``/``spawn_to`` + ``backend.locate``
                                so the thread runs near the data
========  ====================  ==================================================

A violation is suppressed when its source line carries a
``# lint: allow(<rule-name>)`` comment (e.g. the reader-lease grant in
``core/sync.py`` deliberately holds a pinned guard beyond lexical scope).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

RAW_VERBS = {"borrow", "borrow_mut", "deref", "deref_mut", "drop_ref"}
DISPOSE_VERBS = {"transfer", "free", "drop_box", "drop"}
GUARD_CLASSES = {"ReadGuard", "WriteGuard", "Region"}
SPAWN_ROUTED = {"spawn_to", "spawn_near"}

RULES = {
    "E101": "raw-verb",
    "E102": "escaping-payload",
    "E103": "guard-live-conflict",
    "E104": "guard-no-with",
    "E105": "spawn-capture",
}


@dataclass(frozen=True)
class LintViolation:
    file: str
    line: int
    col: int
    code: str
    rule: str
    message: str

    def format(self, style: str = "text") -> str:
        if style == "github":
            # GitHub Actions workflow-command annotation: attaches the
            # message to the offending line in the PR diff view.
            return (
                f"::error file={self.file},line={self.line},col={self.col},"
                f"title={self.code} {self.rule}::{self.message}"
            )
        return f"{self.file}:{self.line}:{self.col}: {self.code} [{self.rule}] {self.message}"


def _attr_call(node: ast.AST) -> str | None:
    """Return the attribute name if ``node`` is an ``x.attr(...)`` call."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _root_name(node: ast.AST) -> str | None:
    """Leftmost ``Name`` of a Name/Attribute/Subscript chain, else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


class _FileLinter:
    def __init__(self, path: str, tree: ast.Module, source: str) -> None:
        self.path = path
        self.tree = tree
        self.lines = source.splitlines()
        self.violations: list[LintViolation] = []
        # Expressions that are with-item context expressions (by identity):
        # these are the *legal* positions for guard-constructor calls.
        self.with_contexts: set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    self.with_contexts.add(id(item.context_expr))
        # Names bound (anywhere in the module) from an alloc-family call —
        # approximation of "this name refers to DSM handles".
        # Block topology: for every statement list, which statement owns it,
        # and for every statement, where it sits.  Used to continue the
        # escaping-payload scan *past* the end of a branch — a `with` that is
        # the last statement of an `else:` still leaks its payload into the
        # statements after the enclosing `if`.
        self.block_parent: dict[int, ast.stmt] = {}
        self.stmt_pos: dict[int, tuple[list[ast.stmt], int]] = {}
        for node in ast.walk(tree):
            lists = [
                getattr(node, f, None) for f in ("body", "orelse", "finalbody")
            ]
            if isinstance(node, ast.Try):
                lists.extend(h.body for h in node.handlers)
            for stmts in lists:
                if not (isinstance(stmts, list) and stmts and isinstance(stmts[0], ast.stmt)):
                    continue
                if isinstance(node, ast.stmt):
                    self.block_parent[id(stmts)] = node
                for j, s in enumerate(stmts):
                    self.stmt_pos[id(s)] = (stmts, j)
        self.handle_names: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                attrs = {
                    a
                    for sub in ast.walk(node.value)
                    if (a := _attr_call(sub)) is not None
                }
                if attrs & {"alloc", "alloc_tied"}:
                    for tgt in node.targets:
                        for n in ast.walk(tgt):
                            if isinstance(n, ast.Name):
                                self.handle_names.add(n.id)

    # -- reporting ---------------------------------------------------------

    def report(self, node: ast.AST, code: str, message: str) -> None:
        rule = RULES[code]
        line = getattr(node, "lineno", 1)
        src = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        if f"lint: allow({rule})" in src or "lint: allow(all)" in src:
            return
        self.violations.append(
            LintViolation(
                file=self.path,
                line=line,
                col=getattr(node, "col_offset", 0) + 1,
                code=code,
                rule=rule,
                message=message,
            )
        )

    # -- rules -------------------------------------------------------------

    def run(self) -> list[LintViolation]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check_raw_verb(node)
                self._check_guard_no_with(node)
                self._check_spawn_capture(node)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                self._check_guard_live_conflict(node)
        # Escaping payloads need statement-list context, not a flat walk.
        for node in ast.walk(self.tree):
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(node, field, None)
                if isinstance(stmts, list):
                    self._check_escaping_payload(stmts)
        self.violations.sort(key=lambda v: (v.line, v.col, v.code))
        return self.violations

    def _check_raw_verb(self, call: ast.Call) -> None:
        attr = _attr_call(call)
        if attr in RAW_VERBS:
            self.report(
                call,
                "E101",
                f"raw protocol verb .{attr}() — use the guard API "
                f"(box.read/box.write/cluster.region) instead",
            )
        elif attr == "drop" and not call.keywords and 1 <= len(call.args) <= 2:
            # `backend.drop(th, h)` / `h.drop(th)` — the legacy disposal verb.
            # Zero-arg and kwarg forms are assumed to be unrelated APIs.
            self.report(
                call,
                "E101",
                "raw protocol verb .drop() — dispose via guard-scoped "
                "backend.free()/drop_box() outside any live guard",
            )

    def _guard_call_target(self, call: ast.Call) -> ast.AST | None:
        """If ``call`` looks like a guard constructor, return the handle expr.

        Guard constructors on the app surface are ``h.read(th)`` /
        ``h.write(th)`` with exactly one positional argument that is a bare
        name (the thread).  This deliberately excludes ``backend.read(th,
        h)`` 2-arg shims, ``f.read()`` file-style calls, and
        ``state.write(state.read())`` value-plumbing (argument is a call,
        not a name).
        """
        if isinstance(call.func, ast.Attribute) and call.func.attr in ("read", "write"):
            if (
                len(call.args) == 1
                and not call.keywords
                and isinstance(call.args[0], ast.Name)
            ):
                return call.func.value
        return None

    def _check_guard_no_with(self, call: ast.Call) -> None:
        if id(call) in self.with_contexts:
            return
        if isinstance(call.func, ast.Name) and call.func.id in GUARD_CLASSES:
            self.report(
                call,
                "E104",
                f"{call.func.id}(...) constructed outside a with statement — "
                f"no structural release on exception",
            )
            return
        if _attr_call(call) == "__enter__":
            self.report(
                call,
                "E104",
                "explicit .__enter__() — the guard is never released if the "
                "scope unwinds; use `with`",
            )
            return
        tgt = self._guard_call_target(call)
        if tgt is not None:
            name = _root_name(tgt) or ast.unparse(tgt)
            self.report(
                call,
                "E104",
                f"guard opened on {name!r} outside a with statement — "
                f"no structural release on exception",
            )

    def _check_guard_live_conflict(self, w: ast.With | ast.AsyncWith) -> None:
        # Handles with a syntactically live guard inside this with body.
        live: list[str] = []
        for item in w.items:
            if isinstance(item.context_expr, ast.Call):
                fn = item.context_expr.func
                if isinstance(fn, ast.Attribute) and fn.attr in ("read", "write"):
                    live.append(ast.unparse(fn.value))
        if not live:
            return
        for node in ast.walk(w):
            attr = _attr_call(node)
            if attr not in DISPOSE_VERBS:
                continue
            assert isinstance(node, ast.Call)
            exprs = [node.func.value, *node.args]  # type: ignore[attr-defined]
            for e in exprs:
                u = ast.unparse(e)
                for h in live:
                    if u == h or u.startswith(h + "."):
                        self.report(
                            node,
                            "E103",
                            f".{attr}() on {h!r} while a guard on it is "
                            f"syntactically live in this with block",
                        )
                        return

    def _check_spawn_capture(self, call: ast.Call) -> None:
        attr = _attr_call(call)
        if attr != "spawn" or attr in SPAWN_ROUTED:
            return
        if any(kw.arg == "server" for kw in call.keywords):
            return
        captured = set()
        for arg in [*call.args, *[kw.value for kw in call.keywords]]:
            captured |= _names_in(arg) & self.handle_names
        if captured:
            names = ", ".join(sorted(captured))
            self.report(
                call,
                "E105",
                f"handle(s) {names} captured by .spawn() without locality "
                f"routing — use spawn_near/spawn_to or pass "
                f"server=backend.locate(h)",
            )

    def _check_escaping_payload(self, stmts: list[ast.stmt]) -> None:
        """Flag guard-payload names read after their with block closed."""
        for i, stmt in enumerate(stmts):
            if not isinstance(stmt, (ast.With, ast.AsyncWith)):
                continue
            payloads: set[str] = set()
            for item in stmt.items:
                ctx = item.context_expr
                is_guard = isinstance(ctx, ast.Call) and (
                    (isinstance(ctx.func, ast.Attribute) and ctx.func.attr in ("read", "write"))
                    or (isinstance(ctx.func, ast.Name) and ctx.func.id in GUARD_CLASSES)
                )
                if is_guard and isinstance(item.optional_vars, ast.Name):
                    payloads.add(item.optional_vars.id)
            if not payloads:
                continue
            # Aliases derived from the payload inside the with body:
            # `tmp = w.value` / `row = v[i]` make `tmp`/`row` payloads too.
            # Only pure access chains alias the payload — a method call
            # (`result = w.update(fn)`) returns a *new* value, not the
            # guarded snapshot, so it may legitimately outlive the guard.
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign) and self._aliases_payload(
                    sub.value, payloads
                ):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Name):
                            payloads.add(tgt.id)
            self._scan_after(stmts, i, payloads)

    @staticmethod
    def _aliases_payload(expr: ast.AST, payloads: set[str]) -> bool:
        """True if ``expr`` is a Name/Attribute/Subscript chain rooted at a
        payload name (``w``, ``w.value``, ``v[i]``, ``v[i].field``)."""
        node = expr
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        return isinstance(node, ast.Name) and node.id in payloads

    def _scan_after(
        self, stmts: list[ast.stmt], i: int, payloads: set[str]
    ) -> None:
        """Scan everything that executes after ``stmts[i]`` closes.

        Walks the remainder of the containing block, then climbs the parent
        chain (`if`/`try`/loop bodies) scanning each enclosing remainder —
        a payload escaping the last statement of an ``else:`` branch is
        still dead in the statements after the ``if``.  The climb stops at
        function/class boundaries (escape-by-return is a different rule).
        """
        dead = set(payloads)
        cur_list, idx = stmts, i
        while dead:
            self._scan_block(cur_list[idx + 1 :], dead)
            owner = self.block_parent.get(id(cur_list))
            if owner is None or isinstance(
                owner, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                return
            pos = self.stmt_pos.get(id(owner))
            if pos is None:
                return
            cur_list, idx = pos

    # The scan respects evaluation order: an assignment's RHS is read
    # *before* the target is rebound (so `v = v + 1` after the with is an
    # escape), while a `for v in xs:` rebinds `v` before its body runs (so
    # body uses of `v` are fine).

    def _scan_block(self, stmts: list[ast.stmt], dead: set[str]) -> None:
        for stmt in stmts:
            if not dead:
                return
            self._scan_stmt(stmt, dead)

    def _scan_stmt(self, stmt: ast.stmt, dead: set[str]) -> None:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            if isinstance(stmt, ast.AugAssign):
                # `v += x` reads the stale payload before rebinding it.
                self._scan_loads([stmt.target, stmt.value], dead, aug=True)
                self._discard_stores([stmt.target], dead)
                return
            if stmt.value is not None:
                self._scan_loads([stmt.value], dead)
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            self._discard_stores(targets, dead)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_loads([stmt.iter], dead)
            self._discard_stores([stmt.target], dead)
            self._scan_block(stmt.body, dead)
            self._scan_block(stmt.orelse, dead)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_loads([item.context_expr], dead)
                if item.optional_vars is not None:
                    self._discard_stores([item.optional_vars], dead)
            self._scan_block(stmt.body, dead)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            # A nested def shadows nothing here reliably; skip its body but
            # treat default-value expressions as loads.
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_loads(
                    [*stmt.args.defaults, *[d for d in stmt.args.kw_defaults if d]],
                    dead,
                )
            dead.discard(stmt.name)
        else:
            exprs: list[ast.AST] = []
            blocks: list[list[ast.stmt]] = []
            for field, value in ast.iter_fields(stmt):
                if field in ("body", "orelse", "finalbody"):
                    blocks.append(value)
                elif field == "handlers":
                    for h in value:
                        if h.type is not None:
                            exprs.append(h.type)
                        blocks.append(h.body)
                elif isinstance(value, ast.AST):
                    exprs.append(value)
                elif isinstance(value, list):
                    exprs.extend(v for v in value if isinstance(v, ast.AST))
            self._scan_loads(exprs, dead)
            for b in blocks:
                self._scan_block(b, dead)

    def _scan_loads(
        self,
        exprs: list[ast.AST],
        dead: set[str],
        aug: bool = False,
        shadow: frozenset[str] = frozenset(),
    ) -> None:
        for e in exprs:
            if isinstance(e, ast.Lambda):
                # Lambda parameters shadow outer names inside the body;
                # default values evaluate in the enclosing scope.
                self._scan_loads(
                    [*e.args.defaults, *[d for d in e.args.kw_defaults if d]],
                    dead,
                    shadow=shadow,
                )
                params = {
                    a.arg
                    for a in (
                        *e.args.posonlyargs,
                        *e.args.args,
                        *e.args.kwonlyargs,
                        *([e.args.vararg] if e.args.vararg else []),
                        *([e.args.kwarg] if e.args.kwarg else []),
                    )
                }
                self._scan_loads([e.body], dead, shadow=shadow | params)
                continue
            if isinstance(e, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                inner = frozenset(shadow)
                for gen in e.generators:
                    self._scan_loads([gen.iter], dead, shadow=inner)
                    inner = inner | _names_in(gen.target)
                    self._scan_loads(gen.ifs, dead, shadow=inner)
                body = (
                    [e.key, e.value] if isinstance(e, ast.DictComp) else [e.elt]
                )
                self._scan_loads(body, dead, shadow=inner)
                continue
            queue = [e]
            while queue:
                node = queue.pop()
                if isinstance(
                    node,
                    (ast.Lambda, ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
                ):
                    self._scan_loads([node], dead, shadow=shadow)
                    continue
                if isinstance(node, ast.Name) and node.id in dead and node.id not in shadow:
                    if isinstance(node.ctx, ast.Load) or aug:
                        self.report(
                            node,
                            "E102",
                            f"guard payload {node.id!r} read after its with "
                            f"block closed — the snapshot may be stale; "
                            f"re-open a guard or copy inside the block",
                        )
                    dead.discard(node.id)
                queue.extend(ast.iter_child_nodes(node))

    def _discard_stores(self, targets: list[ast.AST], dead: set[str]) -> None:
        for t in targets:
            for node in ast.walk(t):
                if isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ):
                    dead.discard(node.id)
                elif isinstance(node, ast.Name) and node.id in dead:
                    # Subscript/attribute store on the payload still reads it.
                    self.report(
                        node,
                        "E102",
                        f"guard payload {node.id!r} written through after its "
                        f"with block closed — mutate inside the guard",
                    )
                    dead.discard(node.id)


def lint_file(path: str | Path) -> list[LintViolation]:
    p = Path(path)
    source = p.read_text()
    try:
        tree = ast.parse(source, filename=str(p))
    except SyntaxError as exc:  # pragma: no cover - corpus files must parse
        return [
            LintViolation(
                file=str(p),
                line=exc.lineno or 1,
                col=(exc.offset or 0) + 1,
                code="E100",
                rule="syntax-error",
                message=str(exc.msg),
            )
        ]
    return _FileLinter(str(p), tree, source).run()


def lint_paths(paths: Iterable[str | Path]) -> list[LintViolation]:
    out: list[LintViolation] = []
    for raw in paths:
        p = Path(raw)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            out.extend(lint_file(f))
    return out
