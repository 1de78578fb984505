"""Host ms a search spends in the engine outside waiting for the device: the
program's ``plan_lookup``, ``execute`` and ``sync`` spans, less the host
time of ``execute``'s one stream wait (``engine.plan._wait``, clocked by the
harness in the traced run); mean over the traced window's rounds (one
search a round)."""

UNIT = "ms"


def read(ctx):
    rounds = ctx.win.get("rounds") or []
    if not rounds:
        return None
    spans = sum(r["spans"].get("plan_lookup", 0.0) + r["spans"].get("execute", 0.0)
                + r["spans"].get("sync", 0.0) for r in rounds)
    waits = sum(ctx.win.get("wait_s") or [])
    return 1e3 * (spans - waits) / len(rounds)
