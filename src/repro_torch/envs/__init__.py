from repro_torch.envs import base, catch, gridworld, token_mdp  # noqa: F401
