from blah2_tpu_torch.runtime.radar import RadarRuntime  # noqa: F401
