from repro_torch.optim.api import init_optimizer  # noqa: F401
