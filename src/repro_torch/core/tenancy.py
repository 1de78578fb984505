"""Identity-based multi-tenancy (paper §3.9) as a pure-function contract
(counterpart of ``repro/core/tenancy.py``).

The paper's service layer verifies Bearer tokens against an OAuth2-style
introspection endpoint; here the HTTP hop is abstracted to an injected
``verify(token) -> user_id | None`` callable (the five-line adapter the paper
describes), with the same semantics:

  * verifier configured  -> failures are rejected (None namespace);
    responses are cached for ``cache_ttl`` seconds; a stale cache entry is
    served if the verifier raises (graceful degradation).
  * standalone mode (no verifier) -> the token IS the namespace key.
  * no token -> the shared ``__public__`` namespace.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

from .. import obs

from .api import MonaVec

PUBLIC_NAMESPACE = "__public__"


@dataclasses.dataclass
class TenantRegistry:
    verifier: Optional[Callable[[str], Optional[str]]] = None
    cache_ttl: float = 30.0
    _cache: Dict[str, Tuple[float, Optional[str]]] = dataclasses.field(default_factory=dict)
    _spaces: Dict[str, Dict[str, MonaVec]] = dataclasses.field(default_factory=dict)
    _clock: Callable[[], float] = time.monotonic

    # -- identity ----------------------------------------------------------

    def resolve_namespace(self, token: Optional[str]) -> Optional[str]:
        """Token -> namespace key (None = reject / 401)."""
        if token is None or token == "":
            return PUBLIC_NAMESPACE
        if self.verifier is None:
            return token  # standalone: token-as-namespace
        now = self._clock()
        hit = self._cache.get(token)
        if hit is not None and now - hit[0] < self.cache_ttl:
            return hit[1]
        try:
            user = self.verifier(token)
        except Exception:
            if hit is not None:  # stale cache served on verifier outage
                return hit[1]
            return None
        self._cache[token] = (now, user)
        return user

    # -- collections ----------------------------------------------------------

    def put(self, token: Optional[str], name: str, index: MonaVec) -> str:
        ns = self.resolve_namespace(token)
        if ns is None:
            obs.inc("tenancy.errors", kind="401")
            raise PermissionError("401: token rejected")
        self._spaces.setdefault(ns, {})[name] = index
        return ns

    def get(self, token: Optional[str], name: str) -> MonaVec:
        """Resolve + fetch; every successful call counts as one request
        under its ``{namespace, collection}`` labels (DESIGN.md §9) — the
        per-namespace request counter the metrics snapshot exposes."""
        ns = self.resolve_namespace(token)
        if ns is None:
            obs.inc("tenancy.errors", kind="401")
            raise PermissionError("401: token rejected")
        try:
            index = self._spaces[ns][name]
        except KeyError:
            obs.inc("tenancy.errors", kind="missing_collection",
                    **{"namespace": ns})
            raise KeyError(f"collection {name!r} not found in namespace {ns!r}") from None
        obs.inc("tenancy.requests", **{"namespace": ns, "collection": name})
        return index

    def collections(self, token: Optional[str]):
        ns = self.resolve_namespace(token)
        if ns is None:
            obs.inc("tenancy.errors", kind="401")
            raise PermissionError("401: token rejected")
        return sorted(self._spaces.get(ns, {}).keys())

    # -- per-namespace mutation (DESIGN.md §6) -----------------------------
    #
    # The segmented lifecycle surfaces through the same token -> namespace
    # -> collection resolution as search: a tenant can only grow/churn its
    # own collections, and every path 401s exactly like get().

    def searcher(self, token: Optional[str], name: str, k: int = 10,
                 where=None, **knobs):
        """Bound engine Searcher over a tenant's collection (DESIGN.md §7):
        the handle the serving loop keeps per (tenant, collection) so every
        request is a plan-cache hit, with the same 401 semantics as get().
        The returned Searcher carries ``{namespace, collection}`` metric
        labels, so each call lands in the per-namespace
        ``tenancy.search_us`` latency histogram (DESIGN.md §9).  ``where=``
        binds a metadata predicate into every call."""
        ns = self.resolve_namespace(token)   # get() below re-checks + counts
        searcher = self.get(token, name).searcher(k=k, where=where, **knobs)
        searcher.labels = (("namespace", ns), ("collection", name))
        return searcher

    def add(self, token: Optional[str], name: str, vectors, ids=None,
            meta=None):
        """Append rows to a tenant's collection; returns the assigned ids."""
        return self.get(token, name).add(vectors, ids=ids, meta=meta)

    def delete(self, token: Optional[str], name: str, ids) -> int:
        """Tombstone rows in a tenant's collection; returns rows deleted."""
        return self.get(token, name).delete(ids)

    def compact(self, token: Optional[str], name: str) -> int:
        """Compact a tenant's collection; returns rows reclaimed."""
        return self.get(token, name).compact()

    def autotune(self, token: Optional[str], name: str,
                 recall_target: float = 0.95, **kwargs):
        raise NotImplementedError("autotune is not ported yet (ROADMAP A11)")
