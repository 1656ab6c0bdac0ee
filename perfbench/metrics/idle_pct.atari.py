"""``idle_pct.atari``: the share of the profiled stretch of whole steps in
which no operation ran on the device (``trace.summarize``); nothing
where the busy time exceeds the stretch, which a sound count cannot."""


def read(run):
    p = run.profile
    if p is None or not 0 < p["busy_s"] <= p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
