from blah2_tpu_torch.net.socket import JsonTcpSender  # noqa: F401
from blah2_tpu_torch.net.api import ApiServer  # noqa: F401
