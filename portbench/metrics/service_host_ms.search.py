"""Host ms a round spends in the service layer: the ``submit`` calls and the
ticket results (the harness's clock) and the part of ``flush()`` outside the
engine's spans (``plan_lookup``, ``execute``, ``sync``: the program's obs
spans); mean over the traced window's rounds."""

UNIT = "ms"


def read(ctx):
    rounds = ctx.win.get("rounds") or []
    if not rounds:
        return None
    total = 0.0
    for r in rounds:
        sp = r["spans"]
        engine = sp.get("plan_lookup", 0.0) + sp.get("execute", 0.0) + sp.get("sync", 0.0)
        total += r["submit"] + r["results"] + r["flush"] - engine
    return 1e3 * total / len(rounds)
