from repro_torch.configs.base import ArchConfig, get_config  # noqa: F401
