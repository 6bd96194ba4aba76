"""Object stores: a local directory, an instrumented in-memory mock, a
read-through byte cache, and a file view that pyarrow's parquet reader
scans (host copy of the JAX package's `common/object_store.py`), and
the server's wire messages (`common/rpc.py`)."""
from liquid_tpu_torch.common.object_store import (  # noqa: F401
    ByteCache, LocalStore, MockStore, ObjectStore, StoreFile, sanitize_url,
)
