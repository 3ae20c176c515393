"""The port's lint: static analysis for hazards in the torch serving and
training code, plus the runtime lock-order tracer (the JAX package's
``analysis/`` package, with its rule ids, messages, waiver syntax and
CLI).

- :mod:`.engine` — AST rule engine: file walker, per-rule visitors,
  structured findings, inline ``# jaxlint: disable=RULE -- reason``
  waivers.
- :mod:`.rules` — JL009, JL011-JL018 and JL022-JL024, resolved through
  the port's launch targets (programs, CUDA graphs, step builders,
  kernel wrappers); its docstring says which JAX rules are not ported
  and why.
- :mod:`.concurrency` — the JL019-JL021 concurrency pass: per-class
  lock/thread indexing, lock-order cycles, unguarded shared state,
  blocking calls under a lock (``--concurrency``).
- :mod:`.lockwatch` — runtime lock-order tracer (``JAXLINT_LOCKWATCH=1``):
  traced locks record acquisition orders into the obs registry and the
  observed graph is asserted acyclic at the end of a load-generator run.

Neither the package nor its CLI imports torch.

CLI: ``python -m pytorch_mnist_ddp_tpu_torch.analysis [paths] [--json]
[--fail-on-warning] [--concurrency] [--rules JL0xx,...] [--baseline
FILE]``.
"""

from .concurrency import CONCURRENCY_RULES
from .engine import Finding, LintEngine, Severity, iter_python_files
from .lockwatch import LockOrderError, make_lock
from .rules import ALL_RULES, rule_by_id

__all__ = [
    "ALL_RULES",
    "CONCURRENCY_RULES",
    "Finding",
    "LintEngine",
    "LockOrderError",
    "Severity",
    "iter_python_files",
    "make_lock",
    "rule_by_id",
]
