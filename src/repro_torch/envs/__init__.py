from repro_torch.envs import base, catch, gridworld  # noqa: F401
