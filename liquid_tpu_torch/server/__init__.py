"""The disaggregated mode: a cache server that compute nodes share over
Arrow Flight, its client and its admin HTTP server (port of
`liquid_tpu/server/`; liquid-cache `src/datafusion-server/` and
`src/datafusion-client/`).  The server answers through the port's engine
on its cache's device.
"""
from liquid_tpu_torch.server.flight import (  # noqa: F401
    LiquidCacheService, LiquidCacheServiceInner,
)
from liquid_tpu_torch.server.client import (  # noqa: F401
    FlightStreamMetrics, LiquidCacheClient, LiquidCacheClientBuilder,
)
from liquid_tpu_torch.server.admin import AdminServer  # noqa: F401
