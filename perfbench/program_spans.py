"""What the readers of the port's own spans share.

The port records spans at its layer boundaries
(``rag_faiss_embedding_tpu_torch.utils.timers``) while a torch profiler
records on the thread that opens them: in a traced run, the device trace's
window. Their times are on ``time.monotonic_ns``, the clock
``tracing.DeviceTrace`` maps the device's events onto.

``records`` gives the records that started in the run's window, or None
where there is nothing to read: an untraced run, a program without the
recorder (a checkout from before it), or a recorder that dropped any
record (the reader would count part of the window as all of it).
"""

from __future__ import annotations

from rag_faiss_embedding_tpu_torch.utils import timers

from .tracing import busy_ns


def records(ctx):
    if not hasattr(timers, "spans") or timers.dropped():
        return None
    return timers.spans(ctx["rec"]["t0"], ctx["rec"]["t1"]) or None


def _ns(r) -> int:
    return r["t1_ns"] - r["t0_ns"]


def ms_per_search(ctx, name: str):
    """Summed time of the ``name`` spans over the searches (the
    ``vector_store.search`` roots), in ms a search."""
    recs = records(ctx)
    if recs is None:
        return None
    searches = sum(r["name"] == "vector_store.search" and r["parent"] is None for r in recs)
    spent = [_ns(r) for r in recs if r["name"] == name]
    return sum(spent) / searches / 1e6 if spent and searches else None


def ms_per_row(ctx, name: str):
    """Summed time of the ``name`` spans over their ``rows``, in ms a row."""
    recs = records(ctx)
    if recs is None:
        return None
    spent = [r for r in recs if r["name"] == name]
    rows = sum(r["counts"]["rows"] for r in spent)
    return sum(map(_ns, spent)) / rows / 1e6 if rows else None


def ms_per_parent_row(ctx, name: str):
    """Summed time of the ``name`` spans over the ``rows`` of their parents
    (``store.commit`` over its ``store.insert``), in ms a row."""
    recs = records(ctx)
    if recs is None:
        return None
    by_id = {r["id"]: r for r in recs}
    spent = [r for r in recs if r["name"] == name and r["parent"] in by_id]
    rows = sum(by_id[r["parent"]]["counts"]["rows"] for r in spent)
    return sum(map(_ns, spent)) / rows / 1e6 if rows else None


def host_bound_idle_share(ctx):
    """Percent of the window each card is idle while no ``*.to_host`` span
    (the host waiting for a card) is open, mean over the cards: the idle
    time the host's own work causes."""
    recs, dev = records(ctx), ctx.get("device")
    if recs is None or dev is None:
        return None
    t0, t1 = ctx["rec"]["t0"], ctx["rec"]["t1"]
    waits = [(max(r["t0_ns"], t0), min(r["t1_ns"], t1)) for r in recs
             if r["name"].endswith(".to_host") and r["t1_ns"] > t0 and r["t0_ns"] < t1]
    cards = len(dev["busy_s"])
    idle = [(t1 - t0) - busy_ns(waits + [(a, b) for _, c, a, b in dev["events"] if c == card])
            for card in range(cards)]
    return 100.0 * sum(idle) / cards / (t1 - t0)
