from repro_torch.models import convnet  # noqa: F401
