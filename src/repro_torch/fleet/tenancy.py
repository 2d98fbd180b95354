"""Per-tenant admission policy: quotas, inflight caps, SLO classes.

The port of ``repro.fleet.tenancy``, line for line.  A
:class:`TenantPolicy` maps one tenant onto the runtime's existing
scheduling vocabulary — ``priority`` and ``deadline_s`` become the
defaults stamped onto the tenant's requests — and adds the two limits
that keep a hot tenant from starving a cold one:

* **QPS quota** — a token bucket (``qps`` refill, ``burst`` capacity):
  sustained traffic above the quota sheds at the door with
  :class:`QuotaExceededError` *before* it can occupy queue space that a
  within-quota tenant needs;
* **inflight cap** — at most ``max_inflight`` admitted-but-unresolved
  requests; beyond it, :class:`InflightLimitError`.  Checked before the
  token bucket so an over-inflight rejection does not also burn quota.

The bucket refills from the *caller-passed* clock reading, so under a
virtual clock every admission verdict is a pure function of submit times
— the fleet tests step time explicitly and assert exact shed counts.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.runtime.queue import AdmissionError


class TenantAdmissionError(AdmissionError):
    """A request shed by its own tenant's policy (not by queue state)."""


class QuotaExceededError(TenantAdmissionError):
    pass


class InflightLimitError(TenantAdmissionError):
    pass


class MethodDeniedError(TenantAdmissionError):
    """The tenant's ACL does not allow the requested servable/method."""


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """One tenant's contract with the fleet.

    ``qps=None`` / ``max_inflight=None`` disable that limit.  ``burst``
    is the token-bucket capacity in requests — the short spike a tenant
    may land above its sustained rate.  ``priority`` and ``deadline_s``
    are the defaults applied to the tenant's requests when the submit
    call doesn't override them (the SLO class, in the existing
    ``Request.priority``/deadline vocabulary).

    ``allowed_methods`` is the tenant's ACL over servable names:
    ``None`` (the default) allows every method, a tuple allows exactly
    those names — so an empty tuple denies everything.  Enforced at
    fleet admission *before* the quota check, so a denied call never
    burns tokens.
    """

    name: str
    priority: int = 0
    qps: Optional[float] = None
    burst: float = 1.0
    max_inflight: Optional[int] = None
    deadline_s: Optional[float] = None
    allowed_methods: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.qps is not None and self.qps <= 0:
            raise ValueError(f"qps must be > 0 or None, got {self.qps}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1 or None, got {self.max_inflight}")
        if self.allowed_methods is not None and \
                not isinstance(self.allowed_methods, tuple):
            # accept lists from config files; the policy stays hashable
            object.__setattr__(
                self, "allowed_methods",
                tuple(str(m) for m in self.allowed_methods))


@dataclasses.dataclass
class _TenantState:
    tokens: float
    last_refill: Optional[float] = None
    inflight: int = 0


class TenantTable:
    """Thread-safe policy lookup + admission accounting per tenant.

    Unknown tenants fall back to ``default`` (unlimited unless the
    deployment narrows it), so single-tenant and anonymous traffic needs
    no registration.  ``acquire`` either admits (consuming one token and
    one inflight slot) or raises; ``release`` returns the inflight slot
    when the request's future resolves — by any path: result, exception,
    or cancellation.
    """

    def __init__(
        self,
        policies: Iterable[TenantPolicy] = (),
        *,
        default: Optional[TenantPolicy] = None,
    ):
        self.default = default or TenantPolicy("default")
        self._policies: Dict[str, TenantPolicy] = {
            p.name: p for p in policies}
        self._state: Dict[str, _TenantState] = {}
        self._lock = threading.Lock()

    def add(self, policy: TenantPolicy) -> None:
        with self._lock:
            self._policies[policy.name] = policy
            self._state.pop(policy.name, None)   # fresh bucket on re-add

    def policy(self, tenant: Optional[str]) -> TenantPolicy:
        if tenant is None:
            return self.default
        return self._policies.get(tenant, self.default)

    def _state_of(self, tenant: str, pol: TenantPolicy) -> _TenantState:
        st = self._state.get(tenant)
        if st is None:
            st = _TenantState(tokens=float(pol.burst))
            self._state[tenant] = st
        return st

    def check_method(self, tenant: Optional[str], method: str) -> None:
        """Raise :class:`MethodDeniedError` unless the tenant's ACL
        allows ``method`` (a servable name).  Stateless — safe to call
        before ``acquire`` so denials never consume quota."""
        pol = self.policy(tenant)
        if pol.allowed_methods is not None and \
                method not in pol.allowed_methods:
            name = tenant if tenant is not None else self.default.name
            raise MethodDeniedError(
                f"tenant {name!r} may not call {method!r} "
                f"(allowed: {list(pol.allowed_methods)})")

    def acquire(self, tenant: Optional[str], now: float) -> None:
        """Admit one request for ``tenant`` at clock reading ``now`` or
        raise.  ``tenant=None`` is the anonymous flow: the default policy
        applies, accounted under its own name."""
        name = tenant if tenant is not None else self.default.name
        pol = self.policy(tenant)
        with self._lock:
            st = self._state_of(name, pol)
            if pol.max_inflight is not None and \
                    st.inflight >= pol.max_inflight:
                raise InflightLimitError(
                    f"tenant {name!r} at inflight cap {pol.max_inflight}")
            if pol.qps is not None:
                if st.last_refill is not None:
                    st.tokens = min(
                        float(pol.burst),
                        st.tokens + (now - st.last_refill) * pol.qps)
                st.last_refill = now
                if st.tokens < 1.0:
                    raise QuotaExceededError(
                        f"tenant {name!r} over quota "
                        f"({pol.qps} qps, burst {pol.burst})")
                st.tokens -= 1.0
            st.inflight += 1

    def release(self, tenant: Optional[str]) -> None:
        name = tenant if tenant is not None else self.default.name
        with self._lock:
            st = self._state.get(name)
            if st is not None and st.inflight > 0:
                st.inflight -= 1

    def state(self, tenant: Optional[str]) -> Dict[str, float]:
        """Introspection for tests and telemetry: tokens + inflight."""
        name = tenant if tenant is not None else self.default.name
        pol = self.policy(tenant)
        with self._lock:
            st = self._state_of(name, pol)
            return {"tokens": st.tokens, "inflight": st.inflight}
