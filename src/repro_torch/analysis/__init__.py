"""Static analysis for distributed correctness (``python -m repro_torch.analysis``).

Port of the JAX package's ``repro.analysis``. Two cooperating passes keep
the paper's headline quantity, the bits that cross the wire, honest:

- **Pass 1, AST lint** (:mod:`repro_torch.analysis.lint` + ``rules/``):
  source-level rules over ``src/repro_torch``: hardcoded mesh axis names
  where a collective's group is picked, host syncs and value-dependent
  control flow in step code, data-moving ``torch.distributed`` calls
  outside the ``repro_torch.comm`` seam (under any import alias), and
  compressor / bits registry consistency.
- **Pass 2, comm audit** (:mod:`repro_torch.analysis.comm_audit`): build a
  small config x strategy matrix, run one step of each under the comm
  seam's wire log (``comm.collectives.wire_log``), and cross-check the
  bytes every collective moves against the analytic
  ``repro_torch.comm.bits`` counters and ``PipelineCommModel``.

Known, intentionally-accepted findings live in ``baseline.json`` next to
this package; ``--check`` gates on anything not in the baseline.
"""
from .findings import Finding, load_baseline  # noqa: F401
from .lint import run_lint  # noqa: F401
