"""Static analysis & runtime guards for the port.

One goal across every pass — fail before the hang, not during it:

- :mod:`veles_tpu_torch.analysis.graph` — pre-run verifier over a
  constructed Workflow (gate deadlocks, Repeater-less cycles,
  unreachable units, dangling attribute links, initialize-order
  violations).
- :mod:`veles_tpu_torch.analysis.recompile` — the capture counter
  (``CaptureWatcher``): hot paths capture once, not per step.
- :mod:`veles_tpu_torch.analysis.lint` — AST lint over the package
  itself (rules VL001–VL007: host syncs inside a capture root, captures
  in loop bodies, raw daemon threads, socket I/O under locks, bare
  except-pass, wall-clock deadlines, ad-hoc latency accounting), and
  the capture surface the VJ and VM rules share.
- :mod:`veles_tpu_torch.analysis.concurrency` — whole-package
  concurrency pass (rules VC001–VC005: lock-order deadlock cycles,
  guarded-state discipline via ``# guarded-by:`` / ``# owned-by:``
  annotations, blocking calls under locks, naked ``Condition.wait``).
- :mod:`veles_tpu_torch.analysis.lockcheck` — opt-in
  (``VELES_LOCKCHECK=1``) runtime lock-order recorder asserting
  acquisition-order acyclicity at teardown; a strict no-op when the
  knob is unset.
- :mod:`veles_tpu_torch.analysis.jitcheck` — capture-surface contract
  pass (rules VJ001–VJ003: control flow on tensors, state rebound under
  a capture, serve-plane bucket discipline).
- :mod:`veles_tpu_torch.analysis.jaxpr_audit` — golden dispatch-graph
  drift gate + VJ005 dtype-policy audit over the steady-state
  computation registry (``veles_tpu_torch.aot.registry``).
- :mod:`veles_tpu_torch.analysis.memplan` — device-memory plan:
  VM001–VM004 residency rules and the golden-footprint gate
  (free-at-last-use live ranges over dispatched ops);
  ``PagedGenerativeEngine.plan_footprint`` plans a live engine.

``python -m veles_tpu_torch.analysis`` runs every gate at once
(:mod:`veles_tpu_torch.analysis.__main__`); the baselines live in
``analysis/baselines/``.
"""

from veles_tpu_torch.analysis.concurrency import (  # noqa: F401
    analyze_package, analyze_source, analyze_sources)
from veles_tpu_torch.analysis.graph import (  # noqa: F401
    GraphDiagnostic, WorkflowVerificationError, format_report,
    verify_graph, verify_or_raise)
from veles_tpu_torch.analysis.jitcheck import (  # noqa: F401
    check_package, check_source, check_sources)
from veles_tpu_torch.analysis.lint import (  # noqa: F401
    RULES, Finding, lint_file, lint_package, lint_source)
from veles_tpu_torch.analysis.lockcheck import (  # noqa: F401
    LockOrderError, Recorder)
from veles_tpu_torch.analysis.recompile import (  # noqa: F401
    CaptureWatcher, RecompileError, assert_max_captures)
