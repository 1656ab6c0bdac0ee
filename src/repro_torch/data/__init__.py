from repro_torch.data.synthetic import (PackedBatchIterator,  # noqa: F401
                                        markov_corpus, rl_episode_batch)
