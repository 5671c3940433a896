"""repro-lint for the PyTorch port: static analysis enforcing the port's
serving invariants (the twin of the JAX package's ``repro.analysis``).

Rules (``python -m repro_torch.analysis --list-rules``):

* **R1** — no host syncs inside ``@hot_path`` functions (``host_pull``, the
  one batched pull per tick or wave, carries a suppression with a reason).
* **R2** — no capture hazards in functions handed to
  ``core/capture.py``'s ``capture``, the port's ``jax.jit``.
* **R3** — kernel hygiene: a plain PyTorch counterpart for every kernel
  launcher, and no ``try`` around a launch.
* **R4** — protocol conformance and scheduler layout/family purity.
* **R0** — suppression markers must carry a reason.

This package imports neither ``torch`` nor ``jax`` at top level, so that
production modules can import ``hot_path`` for free; the runtime capture
counter lives in ``repro_torch.analysis.compile_guard``.
"""
from repro_torch.analysis.core import (Finding, RULE_DOCS, RULES,
                                       analyze_file, analyze_paths,
                                       analyze_source)
from repro_torch.analysis.markers import hot_path

# importing the rule modules populates the registry
from repro_torch.analysis import protocol as _protocol  # noqa: F401
from repro_torch.analysis import rules as _rules  # noqa: F401

__all__ = ["Finding", "RULES", "RULE_DOCS", "analyze_file", "analyze_paths",
           "analyze_source", "hot_path"]
