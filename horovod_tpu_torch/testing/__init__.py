"""Test-support utilities (deterministic fault injection, drills).

Nothing here runs in production paths unless explicitly enabled via env
(``HVD_FAULT_SPEC``); the hooks are no-ops otherwise.
"""

from . import faults  # noqa: F401
