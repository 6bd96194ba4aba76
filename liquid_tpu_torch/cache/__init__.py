"""Cache runtime: entries in five states, budgets, replacement, squeeze
and hydration policies, transcoding, the disk block store."""
from liquid_tpu_torch.cache.core import (  # noqa: F401
    DISK_ARROW, DISK_LIQUID, MEMORY_ARROW, MEMORY_LIQUID, MEMORY_SQUEEZED,
    LiquidCache, LiquidCacheBuilder,
)
from liquid_tpu_torch.cache.policies import (  # noqa: F401
    AlwaysHydrate, Evict, FifoPolicy, LiquidPolicy, LruPolicy, NoHydration,
    TranscodeEvict, TranscodeSqueezeEvict,
)
from liquid_tpu_torch.cache.expressions import (  # noqa: F401
    ExtractDate32, PredicateColumn, SubstringSearch, VariantGet, parse_hint,
)
