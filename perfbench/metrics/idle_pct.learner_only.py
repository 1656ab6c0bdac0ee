"""``idle_pct.learner_only``: ``idle_pct.atari``'s reading (its reader,
found by name), in ``impala_deep_atari.learner_only``, whose rate is
``learner_fps``."""

from perfbench.bench import load_reader

read = load_reader("idle_pct.atari")
