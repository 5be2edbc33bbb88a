"""session_persist_ms: host milliseconds a finished request's session
write takes (``BatchScheduler._persist``: the quorum GET and the PUT with
its context), averaged over the window's writes, timed by the
pass-through store that the benchmark hands the scheduler."""


def read(run):
    s = run.get("persist_s")
    return 1e3 * sum(s) / len(s) if s else None
