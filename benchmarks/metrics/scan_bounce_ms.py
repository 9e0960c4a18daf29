"""Mean host time of one scan-path bounce in the traced slice, ms: the span
`scan.bounce` around each iteration of the integrator's bounce loop
(`integrators/path.py`), which enqueues its intersection, NEE and shading
launches; the host paces the scan path, so this is its step. The reader of
`scan_bounce_ms.scan`."""

from harness import spans


def read(run):
    got = spans.slice_records(run)
    if got is None:
        return None
    bounces = [spans.ms(r) for r in got[0] if r.name == "scan.bounce"]
    return sum(bounces) / len(bounces) if bounces else None
