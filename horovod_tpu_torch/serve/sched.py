"""Tenant-weighted fair admission scheduling (host-side, data-only).

Port of the JAX package's ``serve/sched.py`` (plain Python, copied whole:
the port imports nothing of the JAX package). FIFO admission is the
noisy-neighbor failure mode: one chatty tenant under its stream quota
can fill the held line and the decode slots, and every other tenant's
TTFT degrades behind it. The fix lives entirely on the host side of the
decode-step boundary: WHICH held request is admitted into a free slot is
data (a slot index and a block-table row), so fairness changes no shape
on the device.

:class:`FairScheduler` implements weighted deficit round-robin (DRR)
over tenants, with strict priority classes above it:

* **Priority first.** Only the highest priority class with a pending
  request is eligible in any pick — priorities are for preemption-grade
  separation (interactive vs batch), not proportional sharing.
* **Weighted DRR within a class.** Every pending tenant accrues
  ``weight`` deficit per refill round; a pick costs 1. Over a saturated
  window tenants receive admission slots proportional to their weights
  regardless of how deep any one tenant's backlog is.
* **Per-tenant FIFO.** Within one tenant, requests are admitted in
  arrival order — fairness reorders *across* tenants only, so a
  single-tenant engine degenerates to exactly the FIFO admission order.
* **No banking.** A tenant's deficit is reset when it has nothing
  pending (standard DRR anti-burst rule): an idle tenant cannot save up
  credit and then monopolize the admission line.

Determinism: ties break on (deficit, tenant name), and the scheduler
holds no clock and no RNG — the same (held line, weights, priorities)
always picks the same request, which is what lets the starvation drill
pin completions rather than bound them statistically.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Optional, Sequence

__all__ = ["FairScheduler"]


class FairScheduler:
    """Pick which held request is admitted next, fairly across tenants.

    Args:
      weight_of: tenant name -> scheduling weight (> 0). Consulted at
        every pick, so weight changes (registry ``set_weight``) apply
        from the next admission without any engine restart.
      priority_of: tenant name -> priority class (int, higher wins;
        0 = default). Strictly above the weighted sharing: a pending
        higher class always admits before any lower class.

    Engine-loop-only: the single admitting thread owns the deficit
    state, so there is no lock (same discipline as the block manager's
    allocate/lookup/register flow).
    """

    def __init__(self, weight_of: Callable[[str], float],
                 priority_of: Optional[Callable[[str], int]] = None):
        self._weight_of = weight_of
        self._priority_of = priority_of or (lambda _t: 0)
        self._deficit: Dict[str, float] = {}

    def _weight(self, tenant: str) -> float:
        w = float(self._weight_of(tenant))
        if w <= 0:
            raise ValueError(
                f"tenant {tenant!r} has non-positive scheduling weight "
                f"{w} — weights must be > 0 (use priorities, not zero "
                f"weights, to de-class a tenant)")
        return w

    def pick(self, held: Sequence, *,
             blocked: FrozenSet[str] = frozenset()) -> Optional[int]:
        """Index into ``held`` of the next request to admit, or None
        when every pending tenant is in ``blocked`` (or ``held`` is
        empty). ``blocked`` carries the tenants whose head request is
        starved on a resource only THEY exhausted (a per-tenant block
        budget) — the whole point of per-tenant starvation is that it
        must not hold any other tenant's line.

        Each ``held`` element needs ``.tenant``; FIFO within a tenant
        is preserved by only ever considering a tenant's FIRST held
        request.
        """
        pending: Dict[str, int] = {}
        for i, req in enumerate(held):
            t = req.tenant
            if t in blocked or t in pending:
                continue
            pending[t] = i
        if not pending:
            return None
        top = max(self._priority_of(t) for t in pending)
        eligible = {t: i for t, i in pending.items()
                    if self._priority_of(t) == top}
        # DRR reset: tenants with nothing pending (in this class) drop
        # their deficit — no banking across idle gaps. Blocked tenants
        # KEEP theirs: a budget-starved tenant is waiting, not idle,
        # and must not lose its turn for being throttled.
        live = set(eligible) | set(blocked)
        for t in list(self._deficit):
            if t not in live:
                del self._deficit[t]
        while True:
            ready = [t for t in eligible if self._deficit.get(t, 0.0) >= 1]
            if ready:
                # Deterministic: largest deficit first, name breaks ties.
                t = max(ready, key=lambda n: (self._deficit[n], n))
                self._deficit[t] -= 1.0
                return eligible[t]
            for t in eligible:
                self._deficit[t] = (self._deficit.get(t, 0.0)
                                    + self._weight(t))

    def forget(self, tenant: str) -> None:
        """Drop ``tenant``'s deficit (its adapter was evicted) so tenant
        churn cannot grow the deficit map without bound."""
        self._deficit.pop(tenant, None)
