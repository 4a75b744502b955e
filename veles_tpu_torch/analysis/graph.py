"""Static verifier over a constructed Workflow's control/attribute graph
(port of ``veles_tpu/analysis/graph.py``).

A mis-wired workflow historically surfaced only at run time: a barrier
gate waiting on an edge that can never fire hangs until the stall
detector trips, a dangling ``link_attrs`` target dies as an
AttributeError deep inside ``run()``, a Repeater-less cycle deadlocks
on its own back edge. This pass walks the *structure* of the graph —
control edges, ``ignore_gate`` flags, LinkableAttribute records,
``demand`` declarations — and reports every defect it can prove before
a single unit runs.

Diagnostics (``WG`` = workflow graph):

========  ========  =====================================================
code      severity  meaning
========  ========  =====================================================
WG001     warning   unit has no incoming control links — it never runs
WG002     error     end_point can never fire (run() would stall/hang);
          warning   demoted when end_point simply has no incoming links
                    (job-farm graphs that never call run())
WG003     error     control cycle with no Repeater (ignore_gate) member —
                    every member waits on its own downstream edge
WG004     error     barrier gate can never open: some incoming edges
                    fire, others never can
WG005     error     dangling attribute link (target unit left the
                    workflow, or the target attribute does not exist)
WG006     warning   duplicate attribute link: the same attribute was
                    re-linked to a different source (first link is
                    silently clobbered)
WG007     error     circular demand links — initialize() requeue can
          warning   never converge; demoted to a warning for a demanded
                    attribute that is neither set nor linked (it may
                    still be assigned before initialize)
WG008     warning   gate_block is a constant True — the unit can never
                    run and never propagates
========  ========  =====================================================

Severities are fixed per defect; what *happens* on an error is decided
by ``Workflow.verify`` from ``root.common.analysis.verify``
("error" raises, "warn" logs, "off" skips the pass).

WG009 of the reference (a tenant unit that host-syncs inside its
quantum holds the lease through its device work) has no counterpart:
on a CUDA device the port's quantum waits for its device work before
it releases the lease anyway (``veles_tpu_torch.sched``), so a host
sync inside ``run()`` holds it no longer. The capture counter is
``analysis/recompile.py``; the static gates (``baseline``, ``lint``,
``lockcheck``, ``concurrency``, ``jitcheck``, ``jaxpr_audit``,
``memplan``) sit beside this module and run together as ``python -m
veles_tpu_torch.analysis``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from veles_tpu_torch.mutable import Bool, _link_key

ERROR = "error"
WARNING = "warning"


class GraphDiagnostic:
    """One verifier finding: ``code``, ``severity``, human ``message``,
    and the offending ``units`` (names)."""

    __slots__ = ("code", "severity", "message", "units")

    def __init__(self, code: str, severity: str, message: str,
                 units: Sequence[str] = ()) -> None:
        self.code = code
        self.severity = severity
        self.message = message
        self.units = tuple(units)

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def __str__(self) -> str:
        return "%s [%s] %s" % (self.code, self.severity, self.message)

    def __repr__(self) -> str:
        return "<GraphDiagnostic %s %s units=%s>" % (
            self.code, self.severity, list(self.units))


class WorkflowVerificationError(RuntimeError):
    """Raised by ``Workflow.verify`` when the graph has provable
    defects; ``diagnostics`` carries the full report."""

    def __init__(self, message: str,
                 diagnostics: Sequence[GraphDiagnostic]) -> None:
        super().__init__(message)
        self.diagnostics = list(diagnostics)


def _member_sources(unit, members: Set[int]):
    """Incoming control edges restricted to workflow members."""
    return [src for src in unit.links_from if id(src) in members]


def _strongly_connected(units, members: Set[int]):
    """Tarjan SCC (iterative) over the member control graph; returns
    the list of SCCs, each a list of units."""
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: Set[int] = set()
    stack: List[Any] = []
    sccs: List[List[Any]] = []
    counter = [0]

    for root_unit in units:
        if id(root_unit) in index:
            continue
        work = [(root_unit, iter([t for t in root_unit.links_to
                                  if id(t) in members]))]
        index[id(root_unit)] = low[id(root_unit)] = counter[0]
        counter[0] += 1
        stack.append(root_unit)
        on_stack.add(id(root_unit))
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if id(succ) not in index:
                    index[id(succ)] = low[id(succ)] = counter[0]
                    counter[0] += 1
                    stack.append(succ)
                    on_stack.add(id(succ))
                    work.append((succ, iter(
                        [t for t in succ.links_to if id(t) in members])))
                    advanced = True
                    break
                elif id(succ) in on_stack:
                    low[id(node)] = min(low[id(node)], index[id(succ)])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[id(parent)] = min(low[id(parent)], low[id(node)])
            if low[id(node)] == index[id(node)]:
                scc = []
                while True:
                    member = stack.pop()
                    on_stack.discard(id(member))
                    scc.append(member)
                    if member is node:
                        break
                sccs.append(scc)
    return sccs


def _has_attribute(obj: Any, attr: str) -> bool:
    """Attribute-existence probe that does not mistake a property
    raising AttributeError mid-body for a missing attribute."""
    try:
        getattr(obj, attr)
        return True
    except AttributeError:
        return (attr in getattr(obj, "__dict__", {}) or
                _link_key(attr) in getattr(obj, "__dict__", {}) or
                hasattr(type(obj), attr))
    except Exception:
        # any other failure means the attribute path exists
        return True


def verify_graph(workflow) -> List[GraphDiagnostic]:
    """Run every static check over ``workflow``; returns the full
    diagnostic list (possibly empty), errors first."""
    diags: List[GraphDiagnostic] = []
    units = workflow.units
    start = workflow.start_point
    end = workflow.end_point
    members: Set[int] = {id(u) for u in units}
    members.add(id(start))
    members.add(id(end))
    all_units = list(units)
    for special in (start, end):
        if not any(u is special for u in all_units):
            all_units.append(special)

    # -- WG003: cycles not broken by a Repeater ---------------------------
    deadlocked_scc_members: Set[int] = set()
    for scc in _strongly_connected(all_units, members):
        cyclic = len(scc) > 1 or any(
            u in u.links_to for u in scc)
        if not cyclic:
            continue
        if any(getattr(u, "ignore_gate", False) for u in scc):
            continue
        names = sorted(u.name for u in scc)
        deadlocked_scc_members.update(id(u) for u in scc)
        diags.append(GraphDiagnostic(
            "WG003", ERROR,
            "control cycle %s has no Repeater (ignore_gate) member: "
            "every unit's barrier gate waits on an edge that can only "
            "fire after the unit itself ran. Insert a "
            "veles_tpu_torch.plumbing.Repeater on the cycle-closing edge."
            % (names,), names))

    # -- fireability fixpoint ---------------------------------------------
    # A unit can *ever* run iff its gate can open at least once assuming
    # every dynamic gate expression may be open: start fires by fiat;
    # ignore_gate needs any incoming edge from a fireable unit; a
    # barrier needs all of them.
    fireable: Set[int] = {id(start)}
    changed = True
    while changed:
        changed = False
        for u in all_units:
            if id(u) in fireable:
                continue
            sources = _member_sources(u, members)
            if not sources:
                continue
            if getattr(u, "ignore_gate", False):
                ok = any(id(s) in fireable for s in sources)
            else:
                ok = all(id(s) in fireable for s in sources)
            if ok:
                fireable.add(id(u))
                changed = True

    # -- WG001 / WG004 / WG002 --------------------------------------------
    for u in all_units:
        if u is start:
            continue
        sources = _member_sources(u, members)
        if not sources:
            if u is end:
                diags.append(GraphDiagnostic(
                    "WG002", WARNING,
                    "end_point has no incoming control links: run() "
                    "would stall at the first pass. Link the final "
                    "unit: workflow.end_point.link_from(last_unit). "
                    "(Harmless for job-farm graphs that never run().)",
                    (u.name,)))
            else:
                diags.append(GraphDiagnostic(
                    "WG001", WARNING,
                    "unit %r has no incoming control links — it is "
                    "unreachable from start_point and will never run. "
                    "Link it into the graph or remove it." % u.name,
                    (u.name,)))
            continue
        if id(u) in fireable or id(u) in deadlocked_scc_members:
            continue
        stuck = sorted(s.name for s in sources if id(s) not in fireable)
        live = sorted(s.name for s in sources if id(s) in fireable)
        code = "WG002" if u is end else "WG004"
        if live:
            message = (
                "gate deadlock: %r is a barrier over %s, but the "
                "edge(s) from %s can never fire (their sources are "
                "unreachable or deadlocked). The gate never opens and "
                "run() hangs until the stall detector trips. Drop the "
                "dead edge(s) or make their sources reachable from "
                "start_point." % (u.name, sorted(s.name
                                                 for s in sources), stuck))
        else:
            message = (
                "%r can never fire: all of its incoming edges (from "
                "%s) come from units that never run." %
                (u.name, stuck))
        if u is end:
            message = "end_point can never fire — " + message
        diags.append(GraphDiagnostic(code, ERROR, message, (u.name,)))

    # -- WG005 / WG006: attribute links -----------------------------------
    for u in all_units:
        history: Dict[str, List[Tuple[int, str, str]]] = {}
        for key, value in list(getattr(u, "__dict__", {}).items()):
            if not (key.startswith("_linked_") and key.endswith("_")):
                continue
            name = key[len("_linked_"):-1]
            if not isinstance(value, tuple) or len(value) < 2:
                continue
            target, attr = value[0], value[1]
            target_is_unit = hasattr(target, "links_from") and \
                hasattr(target, "_workflow")
            if target_is_unit and target is not workflow and \
                    id(target) not in members:
                diags.append(GraphDiagnostic(
                    "WG005", ERROR,
                    "dangling attribute link: %r.%s reads %r.%s, but "
                    "%r is not a unit of workflow %r (it was removed "
                    "or belongs to another workflow). Re-link the "
                    "attribute to a member unit." %
                    (u.name, name, target.name, attr, target.name,
                     workflow.name),
                    (u.name, getattr(target, "name", "?"))))
            elif not _has_attribute(target, attr):
                # Attributes produced inside target.initialize() are
                # legitimately absent pre-init (the requeue pattern),
                # so a missing name is only a probable typo — warning.
                tname = getattr(target, "name", type(target).__name__)
                diags.append(GraphDiagnostic(
                    "WG005", WARNING,
                    "dangling attribute link: %r.%s reads %r.%s, but "
                    "%r has no attribute %r — if target.initialize() "
                    "does not produce it, reads will raise "
                    "AttributeError at run time (check the "
                    "link_attrs() spelling)." %
                    (u.name, name, tname, attr, tname, attr),
                    (u.name,)))
        for name, tgt, attr in getattr(u, "_link_history_", ()):
            history.setdefault(name, []).append(
                (id(tgt), getattr(tgt, "name", type(tgt).__name__),
                 attr))
        for name, records in history.items():
            distinct = {(tid, attr) for tid, _, attr in records}
            if len(distinct) > 1:
                sources = sorted("%s.%s" % (tname, attr)
                                 for _, tname, attr in records)
                diags.append(GraphDiagnostic(
                    "WG006", WARNING,
                    "duplicate attribute link: %r.%s was linked to "
                    "multiple sources (%s) — only the last link is "
                    "live, the earlier ones were silently clobbered."
                    % (u.name, name, sources), (u.name,)))

    # -- WG007: demand / initialize-order analysis ------------------------
    # Follow each demanded attribute's link chain STRUCTURALLY (via the
    # per-instance link records) rather than through getattr: a truly
    # circular link chain makes getattr recurse forever, which is
    # exactly the defect to report, not to trip over.
    reported_cycles: Set[frozenset] = set()
    for u in all_units:
        for attr in sorted(getattr(u, "_demanded", ())):
            chain: List[Tuple[Any, str]] = []
            seen_keys: Set[Tuple[int, str]] = set()
            cur_obj, cur_attr = u, attr
            cycle = False
            while True:
                key = (id(cur_obj), cur_attr)
                if key in seen_keys:
                    cycle = True
                    break
                seen_keys.add(key)
                chain.append((cur_obj, cur_attr))
                record = getattr(cur_obj, "__dict__", {}).get(
                    _link_key(cur_attr))
                if record is None:
                    break
                cur_obj, cur_attr = record[0], record[1]
            if cycle:
                cycle_key = frozenset(seen_keys)
                if cycle_key in reported_cycles:
                    continue
                reported_cycles.add(cycle_key)
                names = sorted({getattr(obj, "name",
                                        type(obj).__name__)
                                for obj, _ in chain})
                diags.append(GraphDiagnostic(
                    "WG007", ERROR,
                    "circular demand links between %s (chain %s): "
                    "every read chases the pointer loop forever and "
                    "the initialize requeue can never converge. Break "
                    "the cycle by setting one side to a concrete "
                    "value." % (names, " -> ".join(
                        "%s.%s" % (getattr(obj, "name",
                                           type(obj).__name__), a)
                        for obj, a in chain)), names))
                continue
            if len(chain) > 1:
                continue    # linked: initialize requeue resolves it
            try:
                value = getattr(u, attr, None)
            except Exception:
                continue
            if value is None:
                diags.append(GraphDiagnostic(
                    "WG007", WARNING,
                    "unit %r demands %r but it is neither set nor "
                    "linked — initialize() will deadlock unless it is "
                    "assigned first." % (u.name, attr), (u.name,)))

    # -- WG008: constant-True gate_block ----------------------------------
    for u in all_units:
        gb = getattr(u, "gate_block", None)
        if isinstance(gb, Bool) and gb._op is None and gb._value:
            diags.append(GraphDiagnostic(
                "WG008", WARNING,
                "unit %r has gate_block = Bool(True) with no live "
                "expression: it can never run (nor propagate). Use a "
                "gate expression, or gate_skip to propagate." % u.name,
                (u.name,)))

    diags.sort(key=lambda d: (d.severity != ERROR, d.code, d.units))
    return diags


def format_report(diagnostics: Sequence[GraphDiagnostic],
                  workflow_name: str = "workflow") -> str:
    """Human-readable multi-line verifier report."""
    if not diagnostics:
        return "%s: graph verification clean" % workflow_name
    lines = ["%s: %d graph diagnostic(s):" %
             (workflow_name, len(diagnostics))]
    for d in diagnostics:
        lines.append("  %s" % d)
    return "\n".join(lines)


def verify_or_raise(workflow, mode: Optional[str] = None
                    ) -> List[GraphDiagnostic]:
    """The policy half of ``Workflow.verify``.

    ``mode``: "error" (default) raises WorkflowVerificationError when
    any error-severity diagnostic exists; "warn" logs everything as
    warnings; "off" skips the pass entirely.
    """
    if mode is None:
        from veles_tpu_torch.config import get, root
        mode = get(root.common.analysis.verify, "error")
    if mode == "off":
        return []
    diags = verify_graph(workflow)
    errors = [d for d in diags if d.is_error]
    for d in diags:
        if not d.is_error or mode != "error":
            workflow.warning("verify: %s", d)
    if errors and mode == "error":
        raise WorkflowVerificationError(
            "workflow %r failed graph verification with %d error(s):\n%s"
            % (workflow.name, len(errors),
               "\n".join("  %s" % d for d in errors)), diags)
    return diags
