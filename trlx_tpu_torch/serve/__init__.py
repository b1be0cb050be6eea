"""Serving frontend of the port: admission, per-request state, SLO metrics,
the pump-thread server and the stdlib HTTP/SSE frontend."""

from trlx_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from trlx_tpu_torch.serve.request import ServeRequest  # noqa: F401
from trlx_tpu_torch.serve.scheduler import AdmissionController  # noqa: F401
from trlx_tpu_torch.serve.server import ServeServer  # noqa: F401
