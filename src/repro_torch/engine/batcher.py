"""Micro-batched multi-tenant serving queue (counterpart of
``repro/engine/batcher.py``; DESIGN.md §7).

Requests arriving across calls (and across tenants) are queued, coalesced
per **(namespace, collection, k, where, hybrid?, knobs)** group, and
executed as ONE bucketed plan call per group, so ten 3-query requests cost
one replay of the 32-row bucket's graph instead of ten.  Predicates are
frozen (hashable): equal predicates coalesce into one group, and two of one
structure with other constants form two groups that share one plan and one
graph.  ``text=`` requests (a ``HybridIndex`` collection) coalesce the same
way, their texts concatenated in submission order beside the query rows.

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
    """Handle for one submitted request; ``result()`` flushes if needed.
    ``id`` is the request's sequence number in its batcher; ``t_submit`` and
    ``t_queued`` the host clock (``obs.clock``) when its ``submit`` began and
    returned, which a trace active at ``flush()`` turns into the request's
    ``batcher.submit`` and ``batcher.queue`` spans."""

    __slots__ = ("_batcher", "_result", "_error", "id", "t_submit", "t_queued")

    def __init__(self, batcher: "MicroBatcher", id: int = 0, t_submit: float = 0.0) -> None:
        self._batcher = batcher
        self._result: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._error: Optional[BaseException] = None
        self.id = id
        self.t_submit = self.t_queued = t_submit

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
    """One coalescible (namespace, collection, k, where, hybrid?, knobs) stream."""

    token: Optional[str]          # any token resolving to this namespace
    namespace: str                # resolved at submit — metric label only
    collection: str
    k: int
    knobs: tuple
    where: object = None          # a predicate.Predicate, or None
    queries: List[np.ndarray] = dataclasses.field(default_factory=list)
    texts: Optional[List[List[str]]] = None   # hybrid: the texts of each request
    tickets: List[Ticket] = dataclasses.field(default_factory=list)


class MicroBatcher:
    """Cross-request, cross-tenant query coalescing over a TenantRegistry.

    ``submit`` never executes; ``flush`` drains every group with as few
    bucketed plan executions as possible (whole requests are packed into
    batches of at most ``max_batch`` rows; an oversized single request runs
    alone rather than being split).  The queue's depth and rows are counts
    kept by ``submit`` and cleared by ``flush``.
    """

    def __init__(self, registry, *, max_batch: int = 1024) -> None:
        self.registry = registry
        self.max_batch = int(max_batch)
        self.stats = BatcherStats()
        self._groups: Dict[tuple, _Group] = {}
        self._seq = 0             # the last request's id
        self._pending = 0         # requests queued
        self._pending_rows = 0    # their query rows

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
        the group's search.  ``text=`` (a str, or one str per query row)
        routes the group through the hybrid path: its texts concatenate
        alongside the query rows."""
        t_submit = obs.clock()
        ns = self.registry.resolve_namespace(token)
        if ns is None:
            raise PermissionError("401: token rejected")
        self.registry.get(token, collection)    # missing collection: raise now
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        texts: Optional[List[str]] = None
        if text is not None:
            texts = [text] * int(q.shape[0]) if isinstance(text, str) else list(text)
            if len(texts) != int(q.shape[0]):
                raise ValueError(f"submit: {q.shape[0]} query rows but {len(texts)} texts")
        key = (ns, collection, k, where, texts is not None, tuple(sorted(knobs.items())))
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(
                token=token, namespace=ns, collection=collection, k=k,
                knobs=tuple(sorted(knobs.items())), where=where,
                texts=[] if texts is not None else None)
        self._seq += 1
        ticket = Ticket(self, self._seq, t_submit)
        rows = int(q.shape[0])
        group.queries.append(q)
        if texts is not None:
            group.texts.append(texts)
        group.tickets.append(ticket)
        self._pending += 1
        self._pending_rows += rows
        self.stats.requests += 1
        self.stats.rows += rows
        obs.inc("batcher.requests", namespace=ns)
        obs.inc("batcher.rows", rows, namespace=ns)
        obs.set_gauge("batcher.queue_depth", self._pending)
        obs.set_gauge("batcher.queued_rows", self._pending_rows)
        ticket.t_queued = obs.clock()
        return ticket

    @property
    def pending(self) -> int:
        return self._pending

    @property
    def pending_rows(self) -> int:
        return self._pending_rows

    # -- drain -------------------------------------------------------------

    def _execute(self, group: _Group, queries: List[np.ndarray], tickets: List[Ticket],
                 texts: Optional[List[List[str]]] = None,
                 caller: Optional[obs.Span] = None) -> None:
        """Run one coalesced chunk; a failure (stale collection, knobs the
        collection's backend rejects, ...) is delivered to THIS chunk's
        tickets — other groups and chunks are isolated and still execute.
        Under a trace, each request's ``batcher.submit`` and ``batcher.queue``
        spans (to this chunk's ``batcher.execute``) go under ``caller``."""
        labels = {"namespace": group.namespace}
        rows = sum(int(q.shape[0]) for q in queries)
        with obs.timed_span("batcher.execute", histogram="batcher.flush_us",
                            labels=labels,
                            attrs={"namespace": group.namespace,
                                   "collection": group.collection,
                                   "requests": len(tickets), "rows": rows,
                                   "first_request": tickets[0].id,
                                   "last_request": tickets[-1].id}) as sp:
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
                if texts is not None:
                    tcat = [t for ts in texts for t in ts]
                    scores, ids = index.search(qcat, tcat, k=group.k, **kw)
                else:
                    scores, ids = index.search(qcat, k=group.k, **kw)
            except Exception as e:  # noqa: BLE001 — re-raised at result()
                obs.inc("batcher.errors", **labels)
                for t in tickets:
                    t._error = e
            else:
                self.stats.executions += 1
                obs.inc("batcher.executions", **labels)
                with obs.timed_span("batcher.scatter",
                                    attrs={"requests": len(tickets)}):
                    off = 0
                    for q, t in zip(queries, tickets):
                        m = q.shape[0]
                        t._result = (scores[off: off + m], ids[off: off + m])
                        off += m
        if sp is not None and caller is not None:
            tr = obs.current_trace()
            for t in tickets:
                tr.add("batcher.submit", t.t_submit, t.t_queued, parent=caller, request=t.id)
                tr.add("batcher.queue", t.t_queued, sp.t_start, parent=caller,
                       kind=obs.WAIT, request=t.id)

    def flush(self) -> int:
        """Execute every pending group; returns the number of plan
        executions attempted.  Request order within a group is preserved by
        construction (concat order == submission order)."""
        tr = obs.current_trace()
        caller = None if tr is None else tr.open_span
        with obs.span("batcher.flush"):
            groups, self._groups = self._groups, {}
            self._pending = self._pending_rows = 0
            executions = 0
            for group in groups.values():
                hybrid = group.texts is not None
                chunk_q: List[np.ndarray] = []
                chunk_t: List[Ticket] = []
                chunk_x: Optional[List[List[str]]] = [] if hybrid else None
                rows = 0
                texts = group.texts if hybrid else [None] * len(group.queries)
                for q, x, t in zip(group.queries, texts, group.tickets):
                    if chunk_q and rows + q.shape[0] > self.max_batch:
                        self._execute(group, chunk_q, chunk_t, chunk_x, caller)
                        executions += 1
                        chunk_q, chunk_t, rows = [], [], 0
                        chunk_x = [] if hybrid else None
                    chunk_q.append(q)
                    chunk_t.append(t)
                    if hybrid:
                        chunk_x.append(x)
                    rows += int(q.shape[0])
                if chunk_q:
                    self._execute(group, chunk_q, chunk_t, chunk_x, caller)
                    executions += 1
            if executions:
                self.stats.flushes += 1
                obs.inc("batcher.flushes")
        obs.set_gauge("batcher.queue_depth", self._pending)
        obs.set_gauge("batcher.queued_rows", self._pending_rows)
        return executions
