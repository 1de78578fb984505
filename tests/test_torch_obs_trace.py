"""The port's tracing on the CPU (``repro_torch.obs``): the batcher's
request and queue spans, the device-idle attribution, the device spans of a
search (host-timed stages on the CPU; on the card's path, with stand-in
captures and timing events, the stages' and copies' events read through the
anchor), the O(1) queue gauges and the registry's label-handle cache.  A
trace changes no byte of a search or a batcher round.
"""

import numpy as np
import pytest
import torch

from repro_torch import MonaVec, engine, obs
from repro_torch.core.tenancy import TenantRegistry
from repro_torch.engine import plan as plan_mod
from repro_torch.obs import CALLER, DEVICE, HOST, WAIT, Span

DIM = 32


def _vecs(rng, n, dim=DIM):
    return rng.randn(n, dim).astype(np.float32)


def _batcher(rng, n=80, **build):
    reg = TenantRegistry()
    reg.put("a", "docs", MonaVec.build(_vecs(rng, n), device="cpu", **build))
    return reg, engine.MicroBatcher(reg)


def _walk(span):
    yield span
    for c in span.children:
        yield from _walk(c)


def _named(root, name):
    return [s for s in _walk(root) if s.name == name]


# ---------------------------------------------------------------------------
# The batcher's spans.
# ---------------------------------------------------------------------------

def test_traced_round_has_request_and_queue_spans():
    rng = np.random.RandomState(61)
    _, mb = _batcher(rng)
    mb.submit("a", "docs", _vecs(rng, 2), k=3)            # an earlier round
    mb.flush()
    requests = [_vecs(rng, m) for m in (3, 1, 4)]
    tickets = [mb.submit("a", "docs", q, k=3) for q in requests]
    with obs.trace("round") as tr:
        with obs.span("serve"):
            mb.flush()
    ids = [t.id for t in tickets]
    assert ids == [2, 3, 4]
    serve = tr.root.children[0]
    flush = [c for c in serve.children if c.name == "batcher.flush"]
    assert len(flush) == 1 and [c.name for c in flush[0].children] == ["batcher.execute"]
    execute = flush[0].children[0]
    assert (execute.attrs["first_request"], execute.attrs["last_request"]) == (2, 4)
    assert {c.name for c in execute.children} >= {"plan_lookup", "execute", "sync",
                                                  "batcher.scatter"}
    # Both spans of a request sit under the span open at flush(), with its id.
    submits = [c for c in serve.children if c.name == "batcher.submit"]
    queues = [c for c in serve.children if c.name == "batcher.queue"]
    assert [s.attrs["request"] for s in submits] == ids
    assert [s.attrs["request"] for s in queues] == ids
    assert {s.kind for s in submits} == {HOST} and {s.kind for s in queues} == {WAIT}
    for t, s, w in zip(tickets, submits, queues):
        assert s.t_start == t.t_submit <= s.t_end == t.t_queued == w.t_start
        assert w.t_end == execute.t_start
    assert submits[-1].t_end <= flush[0].t_start
    # No trace at flush(): no spans, the tickets keep their times.
    t = mb.submit("a", "docs", requests[0], k=3)
    assert mb.flush() == 1 and t.t_submit <= t.t_queued


def test_each_chunk_ends_its_own_requests_queue():
    rng = np.random.RandomState(62)
    reg = TenantRegistry()
    reg.put("a", "docs", MonaVec.build(_vecs(rng, 60), device="cpu"))
    mb = engine.MicroBatcher(reg, max_batch=4)
    for m in (3, 2, 4):
        mb.submit("a", "docs", _vecs(rng, m), k=2)
    with obs.trace("round") as tr:
        assert mb.flush() == 3
    executes = _named(tr.root, "batcher.execute")
    queues = _named(tr.root, "batcher.queue")
    assert [e.attrs["first_request"] for e in executes] == [1, 2, 3]
    assert [q.t_end for q in queues] == [e.t_start for e in executes]


def test_failed_group_still_traces_its_requests():
    rng = np.random.RandomState(63)
    _, mb = _batcher(rng)
    bad = mb.submit("a", "docs", _vecs(rng, 2), k=3, ef=1)   # not a BruteForce knob
    good = mb.submit("a", "docs", _vecs(rng, 2), k=3)
    with obs.trace("round") as tr:
        assert mb.flush() == 2
    with pytest.raises(TypeError):
        bad.result()
    assert good.result()[1].shape == (2, 3)
    assert sorted(s.attrs["request"] for s in _named(tr.root, "batcher.queue")) == [1, 2]


# ---------------------------------------------------------------------------
# Idle attribution.
# ---------------------------------------------------------------------------

def _span(name, a, b, children=(), kind=HOST):
    sp = Span(name, t_start=a, kind=kind)
    sp.t_end = b
    sp.children = list(children)
    return sp


def _dev(a, b):
    return _span("device.x", a, b, kind=DEVICE)


def _totals(stretches):
    out = {}
    for cause, a, b in stretches:
        out[cause] = out.get(cause, 0.0) + (b - a)
    return {k: round(v, 9) for k, v in out.items()}


@pytest.mark.parametrize("tree,want", [
    # The innermost open host span takes the idle; the root's remainder is
    # the caller's.
    (lambda: _span("round", 0, 10, [
        _span("outer", 1, 9, [_span("inner", 2, 4), _dev(5, 8)])]),
     {CALLER: 2.0, "outer": 3.0, "inner": 2.0}),
    # A wait span (and what nests in it) is left out: its time goes to its
    # parent.
    (lambda: _span("round", 0, 10, [
        _span("execute", 0, 10, [_span("stream_wait", 3, 9, [_span("x", 4, 5)], WAIT),
                                 _dev(6, 8)])]),
     {"execute": 8.0}),
    # A span that starts before the root stretches the extent back (a
    # request's submit); overlapping siblings: the first to start takes the
    # overlap.
    (lambda: _span("round", 5, 12, [
        _span("batcher.submit", 1, 3), _span("batcher.queue", 3, 6, kind=WAIT),
        _span("a", 6, 9), _span("b", 8, 11), _dev(10, 11)]),
     {"batcher.submit": 2.0, CALLER: 4.0, "a": 3.0, "b": 1.0}),
    # The device busy throughout: no idle.
    (lambda: _span("round", 0, 4, [_span("execute", 0, 4, [_dev(0, 4)])]), {}),
])
def test_idle_stretches(tree, want):
    root = tree()
    got = obs.idle_stretches(root)
    assert _totals(got) == want
    busy = [(s.t_start, s.t_end) for s in _walk(root) if s.kind == DEVICE]
    start = min(s.t_start for s in _walk(root))
    union, t = 0.0, start
    for a, b in sorted(busy):
        union += max(0.0, b - max(a, t))
        t = max(t, b)
    assert sum(b - a for _, a, b in got) == pytest.approx(root.t_end - start - union)
    pieces = sorted((a, b) for _, a, b in got)
    assert all(b1 <= a2 for (_, b1), (a2, _) in zip(pieces, pieces[1:]))


def test_finished_trace_observes_idle_by_cause():
    rng = np.random.RandomState(64)
    _, mb = _batcher(rng)
    obs.registry().reset()
    mb.submit("a", "docs", _vecs(rng, 3), k=3)
    mb.flush()                                       # untraced: trace.* stays out
    assert not any(k.startswith("trace.") for k in obs.registry().snapshot()["histograms"])
    for _ in range(2):
        mb.submit("a", "docs", _vecs(rng, 3), k=3)
        with obs.trace("round") as tr:
            mb.flush()
    assert {s.name for s in _walk(tr.root) if s.kind == DEVICE} == {
        "device.rotate", "device.scan", "device.finalize"}
    assert all(s.name == "execute" for s in _walk(tr.root)
               for c in s.children if c.kind == DEVICE)
    hists = obs.registry().snapshot()["histograms"]
    idle = {k: h for k, h in hists.items() if k.startswith(obs.IDLE_HISTOGRAM + "{")}
    assert f'{obs.IDLE_HISTOGRAM}{{cause="batcher.submit"}}' in idle
    assert all(h["count"] == 2 for h in idle.values())
    assert sum(tr.idle.values()) > 0
    text = tr.render()
    assert "device.scan" in text and "[device]" in text and "device idle" in text


# ---------------------------------------------------------------------------
# The card's path with stand-in captures and timing events.
# ---------------------------------------------------------------------------

class _Event:
    """A CUDA timing event on the CPU: ``record`` reads the host clock."""

    def __init__(self, enable_timing=False, blocking=False, interprocess=False,
                 external=False):
        self.t = None

    def record(self, stream=None):
        self.t = obs.clock()

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _Capture:
    """``plan._Captured`` on the CPU: "captures" by running ``fn`` with the
    stage-event list open, "replays" by running it again into its outputs
    (the stages' events keep the capture's times)."""

    read_events = plan_mod._Captured.read_events

    def __init__(self, fn, dev):
        self.fn, self.graph, self.tally, self.events = fn, None, {}, []
        plan_mod._STAGE_EVENTS = self.events
        try:
            self.out = fn()
        finally:
            plan_mod._STAGE_EVENTS = None

    def replay(self):
        for dst, src in zip(self.out, self.fn()):
            dst.copy_(src)


@pytest.fixture
def card_path(monkeypatch):
    waits = []
    monkeypatch.setattr(plan_mod, "_on_card", lambda dev: True)
    monkeypatch.setattr(plan_mod, "_Captured", _Capture)
    monkeypatch.setattr(plan_mod, "_pinned", lambda like: torch.empty(like.shape,
                                                                      dtype=like.dtype))
    monkeypatch.setattr(plan_mod, "_warm_up", lambda dev, fn: fn())
    monkeypatch.setattr(plan_mod, "_wait", lambda: waits.append(1))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    engine.plan_cache().clear()       # plans made off this path time their stages by the host
    yield waits
    engine.plan_cache().clear()


@pytest.mark.parametrize("knobs,stages", [
    ({}, ["device.rotate", "device.scan", "device.finalize"]),
    ({"rescore_mult": 2}, ["device.rotate", "device.coarse_scan", "device.survivor_topk",
                           "device.gathered_rescore", "device.finalize"]),
])
def test_card_path_reads_stage_and_copy_events(card_path, knobs, stages):
    rng = np.random.RandomState(65)
    idx = MonaVec.build(_vecs(rng, 90), coarse="sign", device="cpu")
    q = _vecs(rng, 5)
    plain = idx.search(q, 4, **knobs)                  # captures; no trace
    assert len(card_path) == 1
    with obs.trace("round") as tr:
        traced = idx.search(q, 4, **knobs)
        idx.search(q, 4, **knobs)                      # one anchor a trace
    assert plain[0].tobytes() == traced[0].tobytes()
    assert plain[1].tobytes() == traced[1].tobytes()
    assert tr.anchor is not None and "anchor_err_us" in tr.root.attrs
    # A wait a replay, through plan._wait; the anchor under execute.
    assert len(card_path) == 1 + 1 + 1
    executes = _named(tr.root, "execute")
    for ex in executes:
        device = [c.name for c in ex.children if c.kind == DEVICE]
        assert device == ["device.h2d"] + stages + ["device.d2h"]
        assert [c.name for c in ex.children if c.kind == WAIT] == ["stream_wait"]
        assert [c.name for c in ex.children if c.kind == HOST] == \
            (["trace.anchor"] if ex is executes[0] else [])
    h2d = _named(tr.root, "device.h2d")[-1]
    assert h2d.t_start <= h2d.t_end <= _named(tr.root, "device.d2h")[-1].t_start
    assert tr.idle is not None and sum(tr.idle.values()) > 0


# ---------------------------------------------------------------------------
# Counters.
# ---------------------------------------------------------------------------

def _recount(mb):
    groups = mb._groups.values()
    return (sum(len(g.tickets) for g in groups),
            sum(int(q.shape[0]) for g in groups for q in g.queries))


def _gauges():
    g = obs.registry().snapshot()["gauges"]
    return int(g["batcher.queue_depth"]), int(g["batcher.queued_rows"])


def test_queue_gauges_equal_a_recount():
    rng = np.random.RandomState(66)
    reg, mb = _batcher(rng)
    steps = [("submit", 3, {}), ("submit", 1, {"ef": 1}), ("bad_token", 2, {}),
             ("submit", 5, {}), ("missing", 1, {}), ("flush", 0, {}), ("submit", 2, {}),
             ("bad_text", 2, {}), ("submit", 4, {"ef": 1}), ("flush", 0, {}),
             ("flush", 0, {}), ("submit", 1, {})]
    for what, m, kw in steps:
        if what == "submit":
            mb.submit("a", "docs", _vecs(rng, m), k=3, **kw)
        elif what == "flush":
            mb.flush()
        else:
            with pytest.raises((PermissionError, KeyError, ValueError)):
                if what == "bad_token":
                    mb.submit("nobody", "docs", _vecs(rng, m), k=3)
                elif what == "missing":
                    mb.submit("a", "nope", _vecs(rng, m), k=3)
                else:
                    mb.submit("a", "docs", _vecs(rng, m), k=3, text=["x"])
        assert (mb.pending, mb.pending_rows) == _recount(mb) == _gauges(), (what, m)


def test_label_handles_follow_reset():
    reg = obs.registry()
    reg.reset()
    obs.inc("t.requests", namespace="a", collection="docs")
    obs.inc("t.requests", collection="docs", namespace="a")     # another order
    obs.inc("t.requests", 2, namespace=1, collection="docs")    # a label made a str
    obs.inc("t.requests", namespace="a", collection="docs")
    obs.inc("t.requests", collection="docs", namespace="1")
    counters = reg.snapshot()["counters"]
    assert counters['t.requests{collection="docs",namespace="a"}'] == 3
    assert counters['t.requests{collection="docs",namespace="1"}'] == 3
    handle = reg.counter("t.requests", namespace="a", collection="docs")
    assert reg.counter("t.requests", collection="docs", namespace="a") is handle
    obs.set_gauge("t.depth", 3, ns=["unhashable"])
    assert reg.snapshot()["gauges"]["t.depth{ns=\"['unhashable']\"}"] == 3.0
    obs.observe("t.us", 5.0, stage="x")
    with pytest.raises(ValueError, match="edges"):
        obs.observe("t.us", 5.0, edges=(1, 2), stage="x")
    with pytest.raises(ValueError, match="counter"):
        reg.gauge("t.requests", namespace="a", collection="docs")
    reg.reset()
    obs.inc("t.requests", namespace="a", collection="docs")
    assert reg.snapshot()["counters"] == {'t.requests{collection="docs",namespace="a"}': 1}
    assert reg.counter("t.requests", namespace="a", collection="docs") is not handle
    obs.set_gauge("t.requests_depth", 1)
    obs.observe("t.us", 5.0, edges=(1, 2), stage="x")           # new edges after reset
    assert reg.snapshot()["histograms"]['t.us{stage="x"}']["edges"] == [1.0, 2.0]
    reg.reset()


# ---------------------------------------------------------------------------
# A trace changes no byte.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build,knobs", [({}, {}), ({"coarse": "sign"}, {"rescore_mult": 2})])
def test_traced_equals_untraced(build, knobs):
    rng = np.random.RandomState(67)
    idx = MonaVec.build(_vecs(rng, 120), device="cpu", **build)
    reg = TenantRegistry()
    reg.put("a", "docs", idx)
    q = _vecs(rng, 7)
    plain = idx.search(q, 5, **knobs)
    with obs.trace("search"):
        traced = idx.search(q, 5, **knobs)
    assert plain[0].tobytes() == traced[0].tobytes()
    assert plain[1].tobytes() == traced[1].tobytes()
    requests = [q[:3], q[3:4], q[4:]]
    rounds = []
    for traced_round in (False, True):
        mb = engine.MicroBatcher(reg)
        tickets = [mb.submit("a", "docs", r, k=5, **knobs) for r in requests]
        if traced_round:
            with obs.trace("round"):
                mb.flush()
        else:
            mb.flush()
        rounds.append(b"".join(t.result()[0].tobytes() + t.result()[1].tobytes()
                               for t in tickets))
    assert rounds[0] == rounds[1]
