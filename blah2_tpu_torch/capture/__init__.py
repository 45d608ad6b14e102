from blah2_tpu_torch.capture.source import Source  # noqa: F401
from blah2_tpu_torch.capture.replay import FileReplaySource  # noqa: F401
from blah2_tpu_torch.capture.synthetic import SyntheticSource, synthetic_cpi  # noqa: F401
from blah2_tpu_torch.capture.capture import Capture, factory_source  # noqa: F401
