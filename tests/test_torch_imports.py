"""The PyTorch port stands alone: no module of `liquid_tpu_torch`, not
`chip_smoke.py`, no example under `examples/torch/` and no
`fuzz/*_torch.py` imports jax, the JAX package or pandas (the card's
machine has no pandas), and the port never picks the CPU on its own.
Every port test file runs torch on one intra-op thread (xdist runs six
files at once on the CPU; eight threads each thrash)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

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
    examples = os.path.join(ROOT, "examples", "torch")
    out += [os.path.join(examples, f) for f in os.listdir(examples)
            if f.endswith(".py")]
    fuzz = os.path.join(ROOT, "fuzz")
    out += [os.path.join(fuzz, f) for f in os.listdir(fuzz)
            if f.endswith("_torch.py")]
    return sorted(out)


def test_sources_include_examples_and_fuzz_loop():
    rel = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert os.path.join("fuzz", "fuzz_byteview_torch.py") in rel
    assert sum(p.startswith(os.path.join("examples", "torch")) for p in rel) \
        == 7


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
                 "bench.tracepoints", "devtools.trace_viz", "bench.micro",
                 "bench.stackoverflow_data", "bench.fuzz", "utils.shuttle",
                 "utils.sync"):
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


def test_new_entry_points_without_cuda_raise(monkeypatch):
    from liquid_tpu_torch.bench import micro
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        micro.run_all(tiny=True, names=["boolean_and_then"])
    assert micro.run_all(tiny=True, names=["boolean_and_then"],
                         device="cpu")[0]["value"] > 0


def test_every_port_test_file_pins_one_thread():
    """Each `tests/test_torch_*.py` calls `torch.set_num_threads(1)` at
    module level, right after importing torch."""
    here = os.path.dirname(os.path.abspath(__file__))
    files = sorted(f for f in os.listdir(here)
                   if f.startswith("test_torch_") and f.endswith(".py"))
    assert len(files) >= 50
    unpinned = []
    for f in files:
        with open(os.path.join(here, f)) as fh:
            body = ast.parse(fh.read(), f).body
        calls = [i for i, n in enumerate(body)
                 if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                 and ast.unparse(n.value) == "torch.set_num_threads(1)"]
        imports = [i for i, n in enumerate(body)
                   if isinstance(n, ast.Assign)
                   and ast.unparse(n) == "torch = pytest.importorskip('torch')"]
        if not (calls and imports and calls[0] == imports[0] + 1):
            unpinned.append(f)
    assert not unpinned, unpinned


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
