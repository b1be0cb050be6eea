"""The paged continuous-batching engine of the port (host half)."""

from trlx_tpu_torch.engine.allocator import (  # noqa: F401
    BlockAllocator,
    BlockPoolExhausted,
    TenantQuotaExceeded,
)
from trlx_tpu_torch.engine.prefix_cache import PrefixCache  # noqa: F401
from trlx_tpu_torch.engine.core import (  # noqa: F401
    SERVE_CLASSES,
    CompletedSequence,
    ContinuousEngine,
    EngineStats,
    kernel_launches,
)
