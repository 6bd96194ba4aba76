"""The PyTorch port stands alone: no module of `liquid_tpu_torch`, and not
`chip_smoke.py`, imports jax, the JAX package or pandas (the card's
machine has no pandas), and the port never picks the CPU on its own."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import pkgutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "liquid_tpu_torch")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "liquid_tpu", "pandas")


def test_no_jax_or_reference_imports_in_sources():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    mods = ["liquid_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], "liquid_tpu_torch.")]
    for name in ("sql.fused_agg", "_native", "arrays.fsst",
                 "arrays.prefixkeys", "arrays.byteview", "bench.runner",
                 "bench.main", "bench.oracle", "bench.tpch_queries",
                 "sql.exec", "sql.fused_star", "sql.device_join",
                 "sql.device_agg", "sql.physical", "ops.join",
                 "ops.groupby", "cache.store", "arrays.ipc",
                 "arrays.hybrid", "utils.dates", "arrays.decimal",
                 "arrays.variant", "io.bloom", "io.pageindex",
                 "common.object_store", "parallel.dist",
                 "parallel.session", "parallel.join", "utils.tracing",
                 "common.rpc", "server", "server.flight", "server.client",
                 "server.admin", "bench.clients", "bench.manifest",
                 "bench.tracepoints", "devtools.trace_viz"):
        assert f"liquid_tpu_torch.{name}" in mods, name
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'liquid_tpu', 'pandas'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_without_cuda_raises(monkeypatch):
    from liquid_tpu_torch.device import resolve_device
    from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiquidCacheLocalBuilder().build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiquidCacheLocalBuilder(device="cuda").build()
    ctx, cache = LiquidCacheLocalBuilder(device="cpu").build()
    assert cache.device.type == "cpu" and ctx.device.type == "cpu"


def test_executor_and_aggregators_need_a_device():
    """Below the entry points nothing defaults to the CPU: the executor
    and the classic aggregators are told their device or fail."""
    from liquid_tpu_torch.sql import device_agg
    from liquid_tpu_torch.sql.exec import QueryExecutor
    with pytest.raises(TypeError, match="device"):
        QueryExecutor({})
    for cls, args in ((device_agg.DeviceGroupedAggregator, (["k"], [])),
                      (device_agg.DeviceScalarAggregator, ([],)),
                      (device_agg.HybridGroupedAggregator, (["k"], [])),
                      (device_agg.HybridScalarAggregator, ([],))):
        with pytest.raises(TypeError, match="device"):
            cls(*args)
        assert torch.device(cls(*args, device="cpu").device).type == "cpu"
    assert QueryExecutor({}, "cpu").device == "cpu"


def test_disk_and_squeeze_options_raise(tmp_path):
    """The disk and squeeze options are taken, as in the reference: the
    store lies in the cache directory, capped, under the given policy."""
    from liquid_tpu_torch.cache.policies import TranscodeEvict
    from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder
    policy = TranscodeEvict()
    ctx, cache = (LiquidCacheLocalBuilder(device="cpu")
                  .with_max_disk_bytes(1 << 20)
                  .with_cache_dir(str(tmp_path))
                  .with_squeeze_policy(policy).build())
    assert cache.budget.max_disk_bytes == 1 << 20
    assert cache.squeeze_policy is policy
    assert cache.disk_path == str(tmp_path / "liquid_cache.bin")
    _ctx, other = LiquidCacheLocalBuilder(device="cpu").build()
    assert other.disk_path.endswith("liquid_cache.bin")
    assert os.path.isdir(os.path.dirname(other.disk_path))
