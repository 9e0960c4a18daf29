"""Mean host time of the film readout per render of the traced slice, ms,
its wait left out: the span `render.readout` (the division on the card and
the copies queued into pinned memory) minus its child `readout.wait` (the
synchronise, in which the card finishes the render). The reader of
`readout_ms.live`."""

from harness import spans


def read(run):
    got = spans.slice_records(run)
    if got is None:
        return None
    recs, roots = got
    waits = {}
    for r in recs:
        if r.name == "readout.wait":
            waits[r.parent] = waits.get(r.parent, 0.0) + spans.ms(r)
    return sum(spans.ms(r) - waits.get(r.id, 0.0)
               for r in recs if r.name == "render.readout") / len(roots)
