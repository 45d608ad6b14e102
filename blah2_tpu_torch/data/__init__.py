from blah2_tpu_torch.data.ddmap import DelayDopplerMap  # noqa: F401
from blah2_tpu_torch.data.detection import Detection  # noqa: F401
from blah2_tpu_torch.data.track import TrackStore, TrackState  # noqa: F401
from blah2_tpu_torch.data.timing import Timing  # noqa: F401
from blah2_tpu_torch.data.iq import IqRingBuffer  # noqa: F401
