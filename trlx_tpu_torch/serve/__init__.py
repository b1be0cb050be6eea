"""Serving frontend of the port: admission, per-request state, SLO metrics,
the pump-thread server, the stdlib HTTP/SSE frontend and the host-RAM
tier of evicted prefix blocks."""

from trlx_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from trlx_tpu_torch.serve.request import ServeRequest  # noqa: F401
from trlx_tpu_torch.serve.scheduler import AdmissionController  # noqa: F401
from trlx_tpu_torch.serve.server import ServeServer  # noqa: F401
from trlx_tpu_torch.serve.tiering import HostTier  # noqa: F401
