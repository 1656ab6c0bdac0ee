from repro_torch.optim.optimizers import (adamw, apply_updates,  # noqa: F401
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, rmsprop, sgd)
from repro_torch.optim.schedules import (constant, cosine,  # noqa: F401
                                         linear_anneal, make_schedule)
