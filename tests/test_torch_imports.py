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
                 "ops.groupby"):
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


def test_disk_and_squeeze_options_raise():
    from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder
    b = LiquidCacheLocalBuilder(device="cpu")
    for call in (lambda: b.with_max_disk_bytes(1 << 20),
                 lambda: b.with_cache_dir("/nonexistent"),
                 lambda: b.with_squeeze_policy(object())):
        with pytest.raises(NotImplementedError):
            call()
