"""Mean host time of `render()`'s dispatch per render of the traced slice,
ms: the span `render.dispatch`, from the call's entry to its first sample
step (the path's choice, `build_pathk_tables` with its `host_snapshot`,
the film's allocation). The card has nothing queued then: the previous
render's readout waited for it. The reader of `dispatch_ms.<cell kind>`
(`.live`, `.offline`)."""

from harness import spans


def read(run):
    got = spans.slice_records(run)
    if got is None:
        return None
    recs, roots = got
    return sum(spans.ms(r) for r in recs if r.name == "render.dispatch") / len(roots)
