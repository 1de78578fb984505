"""Micro-batched multi-tenant serving queue (counterpart of
``repro/engine/batcher.py``; DESIGN.md §7).

Requests arriving across calls (and across tenants) are queued, coalesced
per **(namespace, collection, k, where, knobs)** group, and executed as ONE
bucketed plan call per group, so ten 3-query requests cost one replay of
the 32-row bucket's graph instead of ten.  Predicates are frozen (hashable):
equal predicates coalesce into one group, and two of one structure with
other constants form two groups that share one plan and one graph.
``text=`` (hybrid) requests are ROADMAP A10 and raise at ``submit``.

Because a bucketed plan run returns the same bytes as a direct search
(plan.py), coalescing is invisible to callers: every request gets exactly
the rows a solo ``index.search`` would have returned, in submission order.
Isolation is structural: the group key contains the resolved namespace, so
two tenants' queries never share a plan execution, and authentication
failures surface at ``submit`` time (the 401 contract of TenantRegistry).

    batcher = MicroBatcher(registry)
    t1 = batcher.submit(tok_a, "docs", q1, k=10)
    t2 = batcher.submit(tok_b, "docs", q2, k=10)    # different tenant
    scores, ids = t1.result()                       # flushes the queue
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs


@dataclasses.dataclass
class BatcherStats(obs.DeltaStats):
    """``snapshot``/``since`` come from the shared obs.DeltaStats mixin;
    the same counts also land in the metrics registry (``batcher.*``)."""

    requests: int = 0      # submit() calls accepted
    rows: int = 0          # total query rows submitted
    executions: int = 0    # plan executions issued by flush()
    flushes: int = 0


class Ticket:
    """Handle for one submitted request; ``result()`` flushes if needed."""

    __slots__ = ("_batcher", "_result", "_error")

    def __init__(self, batcher: "MicroBatcher") -> None:
        self._batcher = batcher
        self._result: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._result is not None or self._error is not None

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [m,k], ids [m,k]) for this request's rows — identical to
        what a direct ``index.search`` on the same queries returns.  If this
        request's group failed (e.g. invalid knobs for the collection's
        backend), the failure re-raises HERE, on the affected tickets only."""
        if not self.done():
            self._batcher.flush()
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


@dataclasses.dataclass
class _Group:
    """One coalescible (namespace, collection, k, where, knobs) stream."""

    token: Optional[str]          # any token resolving to this namespace
    namespace: str                # resolved at submit — metric label only
    collection: str
    k: int
    knobs: tuple
    where: object = None          # a predicate.Predicate, or None
    queries: List[np.ndarray] = dataclasses.field(default_factory=list)
    tickets: List[Ticket] = dataclasses.field(default_factory=list)


class MicroBatcher:
    """Cross-request, cross-tenant query coalescing over a TenantRegistry.

    ``submit`` never executes; ``flush`` drains every group with as few
    bucketed plan executions as possible (whole requests are packed into
    batches of at most ``max_batch`` rows; an oversized single request runs
    alone rather than being split).
    """

    def __init__(self, registry, *, max_batch: int = 1024) -> None:
        self.registry = registry
        self.max_batch = int(max_batch)
        self.stats = BatcherStats()
        self._groups: Dict[tuple, _Group] = {}

    # -- enqueue -----------------------------------------------------------

    def submit(
        self,
        token: Optional[str],
        collection: str,
        queries,
        *,
        k: int = 10,
        where=None,
        text=None,
        **knobs,
    ) -> Ticket:
        """Queue one request; auth AND collection existence resolve NOW
        (401 = PermissionError, missing collection = KeyError, both here,
        never poisoning other tenants' flush).  Execution happens at the
        next ``flush()``.  ``where=`` is a metadata predicate, bound into
        the group's search."""
        if text is not None:
            raise NotImplementedError("text= (hybrid search) is not ported yet "
                                      "(ROADMAP A10)")
        ns = self.registry.resolve_namespace(token)
        if ns is None:
            raise PermissionError("401: token rejected")
        self.registry.get(token, collection)    # missing collection: raise now
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        key = (ns, collection, k, where, tuple(sorted(knobs.items())))
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(
                token=token, namespace=ns, collection=collection, k=k,
                knobs=tuple(sorted(knobs.items())), where=where)
        ticket = Ticket(self)
        group.queries.append(q)
        group.tickets.append(ticket)
        self.stats.requests += 1
        self.stats.rows += int(q.shape[0])
        obs.inc("batcher.requests", **{"namespace": ns})
        obs.inc("batcher.rows", int(q.shape[0]), **{"namespace": ns})
        obs.set_gauge("batcher.queue_depth", self.pending)
        obs.set_gauge("batcher.queued_rows", self.pending_rows)
        return ticket

    @property
    def pending(self) -> int:
        return sum(len(g.tickets) for g in self._groups.values())

    @property
    def pending_rows(self) -> int:
        return sum(int(q.shape[0]) for g in self._groups.values()
                   for q in g.queries)

    # -- drain -------------------------------------------------------------

    def _execute(self, group: _Group, queries: List[np.ndarray],
                 tickets: List[Ticket]) -> None:
        """Run one coalesced chunk; a failure (stale collection, knobs the
        collection's backend rejects, ...) is delivered to THIS chunk's
        tickets — other groups and chunks are isolated and still execute."""
        labels = {"namespace": group.namespace}
        rows = sum(int(q.shape[0]) for q in queries)
        with obs.timed_span("batcher.execute", histogram="batcher.flush_us",
                            labels=labels,
                            attrs={"namespace": group.namespace,
                                   "collection": group.collection,
                                   "requests": len(tickets), "rows": rows}):
            # Coalescing factor: requests folded into this one plan call.
            obs.observe("batcher.coalesced_requests", len(tickets),
                        edges=obs.DEFAULT_COUNT_EDGES, **labels)
            try:
                index = self.registry.get(group.token, group.collection)
                qcat = queries[0] if len(queries) == 1 \
                    else np.concatenate(queries)
                kw = dict(group.knobs)
                if group.where is not None:
                    kw["where"] = group.where
                scores, ids = index.search(qcat, k=group.k, **kw)
            except Exception as e:  # noqa: BLE001 — re-raised at result()
                obs.inc("batcher.errors", **labels)
                for t in tickets:
                    t._error = e
                return
            self.stats.executions += 1
            obs.inc("batcher.executions", **labels)
            with obs.timed_span("batcher.scatter",
                                attrs={"requests": len(tickets)}):
                off = 0
                for q, t in zip(queries, tickets):
                    m = q.shape[0]
                    t._result = (scores[off: off + m], ids[off: off + m])
                    off += m

    def flush(self) -> int:
        """Execute every pending group; returns the number of plan
        executions attempted.  Request order within a group is preserved by
        construction (concat order == submission order)."""
        groups, self._groups = self._groups, {}
        executions = 0
        for group in groups.values():
            chunk_q: List[np.ndarray] = []
            chunk_t: List[Ticket] = []
            rows = 0
            for q, t in zip(group.queries, group.tickets):
                if chunk_q and rows + q.shape[0] > self.max_batch:
                    self._execute(group, chunk_q, chunk_t)
                    executions += 1
                    chunk_q, chunk_t, rows = [], [], 0
                chunk_q.append(q)
                chunk_t.append(t)
                rows += int(q.shape[0])
            if chunk_q:
                self._execute(group, chunk_q, chunk_t)
                executions += 1
        if executions:
            self.stats.flushes += 1
            obs.inc("batcher.flushes")
        obs.set_gauge("batcher.queue_depth", self.pending)
        obs.set_gauge("batcher.queued_rows", self.pending_rows)
        return executions
