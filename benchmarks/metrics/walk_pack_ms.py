"""Mean host time per render of the traced slice of the medium branch's
LBVH tables, ms: the span `pack.walk_tables` inside `dispatch.pack`
(`ops/cuda/pathk.py: _walk_tables`, the tree fetched from the host
snapshot, every leaf slot checked against the triangle rows, then packed),
which runs on every render. A program without the span gives None. The
reader of `walk_pack_ms.medium`."""

from harness import spans


def read(run):
    got = spans.slice_records(run)
    if got is None:
        return None
    recs, roots = got
    walks = [spans.ms(r) for r in recs if r.name == "pack.walk_tables"]
    return sum(walks) / len(roots) if walks else None
