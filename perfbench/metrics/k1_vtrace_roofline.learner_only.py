"""``k1_vtrace_roofline.learner_only``: ``k1_vtrace_roofline.atari``'s
reading (its reader, found by name), in
``impala_deep_atari.learner_only``, whose rate is ``learner_fps``."""

from perfbench.bench import load_reader

read = load_reader("k1_vtrace_roofline.atari")
