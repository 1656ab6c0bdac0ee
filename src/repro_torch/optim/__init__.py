from repro_torch.optim.optimizers import (Optimizer, adamw,  # noqa: F401
                                          clip_by_global_norm_, global_norm,
                                          make_optimizer, rmsprop, sgd)
from repro_torch.optim.schedules import (constant, cosine,  # noqa: F401
                                         linear_anneal, make_schedule)
