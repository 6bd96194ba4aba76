"""The port's object stores against the JAX package's, on the CPU.

The `MockStore`, `ByteCache` and `StoreFile` cases of
`tests/test_server.py` that need no server run on both packages' classes
over the same bytes: every read returns the same bytes and every
instrumented count, range, cached block and disk byte is equal (exact).
"""
import io

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import pyarrow as pa  # noqa: E402
import pyarrow.parquet as pq  # noqa: E402

from liquid_tpu.common import object_store as jos  # noqa: E402
from liquid_tpu_torch.common import object_store as tos  # noqa: E402

PKGS = pytest.mark.parametrize("mod", [jos, tos], ids=["ref", "port"])


def _parquet_bytes(n=5000, seed=3):
    rng = np.random.default_rng(seed)
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "val": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
        "name": pa.array(rng.choice(["alpha", "beta", "gamma"], n)),
    })
    sink = io.BytesIO()
    pq.write_table(t, sink)
    return t, sink.getvalue()


def _mock_script(mod):
    ms = mod.MockStore({"a": b"0123456789"})
    out = [ms.get_range("a", 2, 3), ms.get("a"), ms.get_access_count("a"),
           ms.get_access_ranges("a"), ms.size("a"), ms.list()]
    fork = ms.fork()
    out += [fork.get_access_count("a"), fork.get("a"),
            ms.get_access_count("a")]
    ms.put("b", b"xyz")
    out += [ms.list(), ms.get_range("b", 1, 10)]
    return out


def test_mock_store_instrumentation_matches_the_reference():
    got, want = _mock_script(tos), _mock_script(jos)
    assert got == want
    assert got[:4] == [b"234", b"0123456789", 2, [(2, 5), (0, 10)]]
    assert got[6:9] == [0, b"0123456789", 2]  # the fork is isolated


def _byte_cache_script(mod, d):
    blob = bytes(range(256)) * 40  # 10240 bytes
    ms = mod.MockStore({"obj": blob})
    bc = mod.ByteCache(ms, d, block_size=4096)
    out = [bc.get_range("obj", 100, 50) == blob[100:150],
           ms.get_access_ranges("obj"),
           bc.get_range("obj", 200, 100) == blob[200:300],
           ms.get_access_count("obj"),
           bc.get_range("obj", 4000, 5000) == blob[4000:9000],
           ms.get_access_count("obj"), bc.cached_blocks("obj"),
           bc.disk_usage(), bc.get("obj") == blob,
           ms.get_access_ranges("obj"), bc.size("obj")]
    return out


def test_byte_cache_block_alignment_matches_the_reference(tmp_path):
    got = _byte_cache_script(tos, str(tmp_path / "t"))
    want = _byte_cache_script(jos, str(tmp_path / "j"))
    assert got == want
    # aligned upstream reads, once per 4096-byte block
    assert got[1] == [(0, 4096)] and got[3] == 1 and got[5] == 3
    assert got[6] == 3 and got[7] == 4096 + 4096 + (10240 - 8192)


@PKGS
def test_store_file_parquet_roundtrip(mod, tmp_path):
    t, data = _parquet_bytes()
    ms = mod.MockStore({"f.parquet": data})
    bc = mod.ByteCache(ms, str(tmp_path / "bc"))
    assert pq.read_table(mod.StoreFile(bc, "f.parquet")).equals(t)


def test_store_file_reads_the_same_ranges(tmp_path):
    """pyarrow's reads through a StoreFile reach the store as the same
    byte ranges in both packages."""
    _t, data = _parquet_bytes(20_000)
    ranges = []
    for mod in (jos, tos):
        ms = mod.MockStore({"f.parquet": data})
        f = mod.StoreFile(ms, "f.parquet")
        pq.ParquetFile(f).read_row_group(0, columns=["val"])
        ranges.append(ms.get_access_ranges("f.parquet"))
    assert ranges[0] == ranges[1] and ranges[0]


@PKGS
def test_local_store_and_sanitize_url(mod, tmp_path):
    (tmp_path / "x.bin").write_bytes(b"abcdefgh")
    ls = mod.LocalStore(str(tmp_path))
    assert ls.size("/x.bin") == 8
    assert ls.get_range("x.bin", 2, 3) == b"cde"
    assert ls.get("x.bin") == b"abcdefgh"
    assert mod.sanitize_url("s3://bucket/a b!") == "s3___bucket_a_b_"
    f = mod.StoreFile(ls, "x.bin")
    assert (f.seek(-3, 2), f.read(), f.tell(), f.read()) == (
        5, b"fgh", 8, b"")
