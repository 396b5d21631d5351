"""Stall injection for the reclamation plane.

The paper's acknowledged weakness — and the robust schemes' raison
d'etre — is a thread that stops cooperating while inside a critical
region: it never completes its step, never releases its hold, and for
stamp-it/epoch-family schemes every page retired from then on is pinned
behind it.  :class:`StallInjector` reproduces exactly that actor against
any :class:`~repro_torch.memory.policy.ReclamationPolicy` (or the BlockPool
wrapping one): it opens holds and begins steps that it deliberately
never closes, so benchmarks and tests can measure each scheme's
*stalled-thread memory bound* (peak unreclaimed pages) — the metric
Hyaline and Crystalline are built around and
the JAX package's robustness bench gates.

The injector keeps handles to everything it parked, so a scenario can
end the stall (``release_all``) and measure recovery, or leave it to the
lifecycle plane's hold-age watchdog to force-expire.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .policy import PolicyHold, ReclamationPolicy


def _policy_of(target) -> ReclamationPolicy:
    """Accept a ReclamationPolicy or anything with a ``.policy`` (a
    BlockPool) — benches drive pools, unit tests drive bare policies."""
    if isinstance(target, ReclamationPolicy):
        return target
    return target.policy


class StallInjector:
    """Parks holds and step handles that are never voluntarily closed.

    A parked HOLD models a wedged host actor (checkpoint writer,
    migration, chunked admission) that stopped mid-critical-region; a
    parked STEP models a dispatched device step whose issuer died before
    observing completion.  Both are the paper's stalled thread at the
    serving layer."""

    def __init__(self) -> None:
        self._holds: List[Tuple[ReclamationPolicy, PolicyHold]] = []
        self._steps: List[Tuple[ReclamationPolicy, int]] = []
        self.released_holds = 0
        self.completed_steps = 0

    # -- park -----------------------------------------------------------
    def park_hold(self, target, tag: str = "stalled") -> PolicyHold:
        """Open a hold on ``target`` (policy or pool) and never release
        it.  Returns the hold (the watchdog or ``release_all`` may still
        end the stall from outside)."""
        policy = _policy_of(target)
        h = policy.hold(tag)
        self._holds.append((policy, h))
        return h

    def park_step(self, target, page_refs: Sequence[tuple] = ()) -> int:
        """Begin a step on ``target`` that is never completed."""
        policy = _policy_of(target)
        handle = policy.begin_step(list(page_refs))
        self._steps.append((policy, handle))
        return handle

    # -- end the stall ---------------------------------------------------
    def release_all(self) -> dict:
        """Cooperatively end every injected stall (recovery phase of a
        scenario).  Holds already force-expired by a watchdog release as
        idempotent no-ops."""
        for policy, h in self._holds:
            if not h.released:
                self.released_holds += 1
            h.release()
        self._holds.clear()
        for policy, handle in self._steps:
            policy.complete_step(handle)
            self.completed_steps += 1
        self._steps.clear()
        return {"holds": self.released_holds, "steps": self.completed_steps}

    # -- observability ---------------------------------------------------
    def parked_holds(self) -> List[PolicyHold]:
        """The injected holds (any state) — what a watchdog sweeps."""
        return [h for _, h in self._holds]

    def live_holds(self) -> int:
        return sum(1 for _, h in self._holds if not h.released)

    def stats(self) -> dict:
        return {
            "holds_parked": len(self._holds),
            "steps_parked": len(self._steps),
            "holds_live": self.live_holds(),
            "holds_released": self.released_holds,
            "steps_completed": self.completed_steps,
        }
