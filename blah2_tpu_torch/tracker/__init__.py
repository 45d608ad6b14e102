from blah2_tpu_torch.tracker.tracker import Tracker  # noqa: F401
