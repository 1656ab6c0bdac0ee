"""``actor_ms.atari``: ms a step in the source's ``next_batch`` (the
device actors' unroll, ``DeviceSource``), from the traced run's spans,
which synchronize on both sides: the mean over the window's steps."""


def read(run):
    spans = run.spans.get("source")
    return 1e3 * sum(spans) / len(spans) if spans else None
