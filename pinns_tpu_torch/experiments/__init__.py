from pinns_tpu_torch.experiments.presets import PRESETS, get_preset  # noqa: F401
