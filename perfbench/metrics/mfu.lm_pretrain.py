"""``mfu.lm_pretrain``: ``mfu.lm``'s reading (its reader, found by name),
in ``granite_3_0_1b_a400m.lm_pretrain``, whose rate is
``pretrain_tokens_per_s``."""

from perfbench.bench import load_reader

read = load_reader("mfu.lm")
