"""``learner_ms.learner_only``: ``learner_ms.atari``'s reading (its reader,
found by name), in ``impala_deep_atari.learner_only``, whose rate is
``learner_fps``."""

from perfbench.bench import load_reader

read = load_reader("learner_ms.atari")
