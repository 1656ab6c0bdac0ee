"""``learner_ms.lm``: ms a step in the learner step (``compiled.TrainStep``
over the program's learner), from the traced run's spans, which
synchronize on both sides: the mean over the window's steps."""


def read(run):
    spans = run.spans.get("learner")
    return 1e3 * sum(spans) / len(spans) if spans else None
