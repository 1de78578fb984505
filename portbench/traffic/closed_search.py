"""Traffic kind ``closed_search``: ``clients`` clients, each with one request
of ``rows_per_request`` query rows outstanding, through the service layer
(``TenantRegistry`` -> ``MicroBatcher``): the server loop submits every
outstanding request, calls ``flush()`` and hands each ticket's result back,
and every client then sends its next request at once.  Rows are drawn with
replacement, from the seed, out of a pool of ``pool`` stand-in queries held
on the host.  ``coarse`` attaches the binarized codes after the build and
``knobs`` go to every request (``rescore_mult``).  The mix's other keys:
``k``, ``warmup_rounds``, ``check_requests`` (requests the judge samples).

The corpus is freed once the index and the query pool are made from it (the
index holds its own codes), and made again from the seed for the judge.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from portbench.harness import data, judge
from portbench.harness import device as devmod
from portbench.harness.context import Context

TOKEN = "bench"
COLLECTION = "default"


def run(ctx: Context) -> None:
    t = ctx.cell.traffic
    cfg = ctx.cell.config
    clients, rows, k = t["clients"], t["rows_per_request"], t["k"]
    knobs = dict(t.get("knobs") or {})
    port = ctx.port
    x = data.corpus(cfg, ctx.seed, ctx.device)
    ctx.mark("data")
    index = ctx.build_index(x)
    if t.get("coarse"):
        index.enable_coarse(t["coarse"])
    ctx.mark("build")
    registry = port.TenantRegistry()
    registry.put(TOKEN, COLLECTION, index)
    batcher = port.MicroBatcher(registry)
    pool = data.query_pool(cfg, x, ctx.seed, t["pool"])
    ctx.state.update(index=index, pool=pool, corpus_print=data.fingerprint(x))
    del x
    ctx.drop_cached()
    ctx.mark("query pool")
    rng = np.random.default_rng([ctx.seed % (1 << 63), 7])

    log = _Requests(clients, rows, k)

    def one_round(record: bool):
        picks = rng.integers(0, pool.shape[0], size=(clients, rows))
        tickets, t_sub = [], np.empty(clients)
        t_a = time.perf_counter()
        for c in range(clients):
            t_sub[c] = time.perf_counter()
            tickets.append(batcher.submit(TOKEN, COLLECTION, pool[picks[c]], k=k, **knobs))
        t_b = time.perf_counter()
        if record and ctx.trace:
            with port.obs.trace("round") as tr:
                batcher.flush()
        else:
            tr = None
            batcher.flush()
        t_c = time.perf_counter()
        slot = log.next_round() if record else None
        for c, ticket in enumerate(tickets):
            try:
                res = ticket.result()
            except Exception:   # noqa: BLE001 -- a request that fails is counted
                res = None
            done = time.perf_counter()
            if slot is not None:
                log.put(slot, c, picks[c], done - t_sub[c], res)
        if record and ctx.trace:
            spans: dict = {}
            _span_totals(tr.root, spans)
            ctx.win["rounds"].append({"submit": t_b - t_a, "flush": t_c - t_b,
                                      "results": done - t_c, "spans": spans})

    for _ in range(t["warmup_rounds"]):
        one_round(False)
    ctx.win.update(rounds=[])
    traced = ctx.trace and ctx.on_card
    ctx.replays = devmod.ReplayTimer() if traced else None
    wait_s = _WaitClock(port.plan) if ctx.trace else None
    # The set-up's objects out of the collector's way: the window's
    # collections then scan only what the window allocates.
    gc.collect()
    gc.freeze()
    t_start = ctx.mark_window_start()
    with (ctx.replays.installed() if traced else contextlib.nullcontext()), \
            (wait_s.installed() if wait_s is not None else contextlib.nullcontext()):
        while True:
            one_round(True)
            t_end = time.perf_counter()
            if t_end - t_start >= ctx.seconds:
                break
    ctx.window_s = t_end - t_start
    gc.unfreeze()
    ctx.win.update(log.arrays())
    if wait_s is not None:
        ctx.win["wait_s"] = wait_s.waits


def rows_done(ctx: Context) -> int:
    return int(ctx.win["ok"].sum()) * ctx.cell.traffic["rows_per_request"]


def attempted(ctx: Context) -> int:
    return int(ctx.win["ok"].shape[0])


def outputs(ctx: Context) -> dict:
    return judge.search_outputs(ctx)


def compare(ctx: Context, out: dict, control: bool = False) -> dict:
    return judge.search_numbers(ctx, out, control=control)


def busy_s(ctx: Context) -> float:
    """Device seconds of the window's graph replays (their CUDA events)."""
    return ctx.replays.device_s()


def device_ops(ctx: Context) -> list:
    """The device operations of the window's plan, its stages run eagerly at
    the round's bucket under torch.profiler (a replay is not traced)."""
    t = ctx.cell.traffic
    index = ctx.state["index"]
    q = ctx.state["pool"][:t["clients"] * t["rows_per_request"]]
    knobs = dict(t.get("knobs") or {})

    def eager():
        ctx.port.plan.search_eager(index.backend, None, q, t["k"], **knobs)

    eager()
    with devmod.profiled() as prof:
        eager()
    return devmod.top_ops(devmod.device_activity(prof))


def idle_gaps(ctx: Context) -> list:
    """The host's work while the device waited: the harness's and the
    program's host spans, summed over the traced window's rounds."""
    rounds = ctx.win.get("rounds") or []
    if not rounds:
        return []
    tot = {"submit": 0.0, "results": 0.0, "engine": 0.0, "sync": 0.0, "scatter": 0.0,
           "service_other": 0.0}
    for r in rounds:
        sp = r["spans"]
        engine = sp.get("plan_lookup", 0.0) + sp.get("execute", 0.0)
        tot["submit"] += r["submit"]
        tot["results"] += r["results"]
        tot["engine"] += engine
        tot["sync"] += sp.get("sync", 0.0)
        tot["scatter"] += sp.get("batcher.scatter", 0.0)
        tot["service_other"] += r["flush"] - engine - sp.get("sync", 0.0) \
            - sp.get("batcher.scatter", 0.0)
    tot["engine"] -= sum(ctx.win.get("wait_s") or [])
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])]


def _span_totals(span, out: dict) -> None:
    for child in span.children:
        if child.t_end is not None:
            out[child.name] = out.get(child.name, 0.0) + (child.t_end - child.t_start)
        _span_totals(child, out)


class _Requests:
    """The window's requests in preallocated blocks of rounds (few Python
    objects, so the harness adds little to the collector's work): each
    request's pool rows, latency, scores, ids and whether it was answered."""

    ROUNDS = 256

    def __init__(self, clients: int, rows: int, k: int) -> None:
        self.shape = (clients, rows, k)
        self.blocks: list = []
        self.used = 0

    def next_round(self):
        c, r, k = self.shape
        if not self.blocks or self.used == self.ROUNDS:
            n = self.ROUNDS
            self.blocks.append({"picks": np.zeros((n, c, r), np.int64),
                                "latency_s": np.zeros((n, c)), "ok": np.zeros((n, c), bool),
                                "scores": np.zeros((n, c, r, k), np.float32),
                                "ids": np.zeros((n, c, r, k), np.uint64)})
            self.used = 0
        self.used += 1
        return self.blocks[-1], self.used - 1

    def put(self, slot, c: int, picks, latency: float, res) -> None:
        block, i = slot
        block["picks"][i, c] = picks
        block["latency_s"][i, c] = latency
        if res is not None:
            block["ok"][i, c] = True
            block["scores"][i, c] = res[0]
            block["ids"][i, c] = res[1]

    def arrays(self) -> dict:
        """Every request, in order: picks [N, rows], latency_s [N], ok [N],
        scores and ids [N, rows, k]; ``failed`` the unanswered count."""
        out = {}
        for key in ("picks", "latency_s", "ok", "scores", "ids"):
            cat = np.concatenate([b[key][:self.ROUNDS if j < len(self.blocks) - 1 else self.used]
                                  for j, b in enumerate(self.blocks)])
            out[key] = cat.reshape((-1,) + cat.shape[2:])
        out["failed"] = int((~out["ok"]).sum())
        return out


class _WaitClock:
    """Host seconds the engine spends waiting for the device: wraps the
    program's one stream wait (``engine.plan._wait``) for the traced window."""

    def __init__(self, plan) -> None:
        self.plan = plan
        self.waits: list = []

    @contextlib.contextmanager
    def installed(self):
        original = self.plan._wait

        def timed():
            t0 = time.perf_counter()
            original()
            self.waits.append(time.perf_counter() - t0)

        self.plan._wait = timed
        try:
            yield self
        finally:
            self.plan._wait = original
