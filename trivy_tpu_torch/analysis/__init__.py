"""Project invariant linter + concurrency witness of the port
(docs/static-analysis.md), copies of trivy_tpu/analysis/ over
``trivy_tpu_torch/``:

- ``analysis.lint`` — AST project linter (``python -m
  trivy_tpu_torch.analysis.lint`` or the ``lint`` CLI subcommand) with
  a pluggable rule framework, inline suppressions, a JSON report mode
  and the shared baseline file.
- ``analysis.witness`` — opt-in (``TRIVY_TPU_LOCK_WITNESS=1``) runtime
  lock-acquisition-order graph over the port's named locks, with cycle
  detection at test teardown.
- ``analysis.lockstatic`` — static companion: extracts ``with <lock>``
  nesting from the AST and cross-checks it against the witnessed
  runtime graph.
- ``analysis.knobs`` — the ``TRIVY_TPU_*`` env-knob registry of the
  port that ``docs/knobs_torch.md`` is generated from.

This ``__init__`` stays import-light on purpose: production modules
import ``analysis.witness`` at module load to name their locks, and
that import must not drag in the AST machinery.
"""
