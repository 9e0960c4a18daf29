"""Share of the traced slice, %, in which no kernel, copy or fill runs on
the card (from the first render's start to the last one's end). The
reader of `device_idle_pct.<cell kind>` (`.offline`, `.scan`, `.live`)."""

from harness.timeline import idle_pct


def read(run):
    t = run.trace
    if t is None:
        return None
    return idle_pct(t.busy_s, t.window_s)
