"""Completeness audit: every public top-level function and class of the
JAX package has a counterpart in the port.

Read with `ast`, importing neither package: for every
`liquid_tpu/**/*.py`, each public top-level `def` / `class` must be
defined (or imported, or assigned) at the top level of the module of the
same path under `liquid_tpu_torch/`, or have an entry in `DEPARTURES`.
An entry maps `"module:name"` (or `"module:*"`, the whole module) to the
port's files or `file::name`s that do that work; each target must exist.
An entry is kept only while the port lacks the name, so the table is the
whole list of departures.
"""
import ast
import functools
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REF = os.path.join(ROOT, "liquid_tpu")
PORT = os.path.join(ROOT, "liquid_tpu_torch")

#: reference "module:name" or "module:*" -> the port's counterparts, as
#: paths under liquid_tpu_torch/ ("file" or "file::name"), and why
DEPARTURES = {
    # the Pallas kernels: hand-written CUDA C++ for Hopper
    "ops/bitpack_pallas.py:*": (
        ("ops/bitpack_cuda.py::cmp_const_many",
         "ops/bitpack_cuda.py::in_interval_many",
         "ops/bitpack_cuda.py::count_gt",
         "ops/bitpack_cuda.py::cmp_const_planes",
         "ops/bitpack_cuda.py::select_planes", "ops/csrc/cmp_const_many.cu",
         "ops/csrc/cmp_planes.cu", "ops/csrc/select_planes.cu"),
        "K1, K3 and K4 as CUDA kernels with their plain versions"),
    "ops/grouphist_pallas.py:*": (
        ("ops/grouphist_cuda.py::group_accumulate", "ops/grouphist_cuda.py::plan",
         "ops/csrc/group_accumulate.cu"),
        "K2 as a CUDA kernel; its launch plan replaces the hi/lo split"),
    # the pandas oracles: the card's machine has no pandas
    "bench/tpch_ref.py:*": (("bench/oracle.py::ORACLES",),
                            "pyarrow oracles of the TPC-H queries"),
    "bench/tpcds_ref.py:*": (("bench/oracle.py::TPCDS_ORACLES",),
                             "pyarrow oracles of the TPC-DS queries"),
    # helpers the port restructured
    "_native/__init__.py:available": (
        ("_native/__init__.py::lib",),
        "the FSST library is required: `lib()` builds it or raises"),
    "io/parquet.py:cached_metadata": (
        ("io/parquet.py::ParquetTable",),
        "a table reads the footer of the file it opens; a process-wide "
        "cache keyed by path would serve a rewritten file's old footer"),
    "parallel/session.py:apply_having": (
        ("parallel/session.py::finish",),
        "HAVING, the items' arithmetic and ORDER BY in one finishing step"),
    "parallel/session.py:apply_post_items": (
        ("parallel/session.py::finish",), "as apply_having"),
    "parallel/session.py:hash_rounds_body": (
        ("parallel/session.py::hash_rounds",),
        "the salted rounds run as one loop, no traced body"),
    "sql/fused_agg.py:eval_ir": (
        ("sql/fused_agg.py::eval_ir_nulls",),
        "one three-valued evaluator: values and NULL masks together"),
}


def _modules(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root).replace(os.sep, "/")] = p
    return out


@functools.lru_cache(maxsize=None)
def _tree(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), path)


def public_defs(path):
    """Public top-level `def` / `class` names."""
    return {n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def top_level_names(path):
    """Every name bound at a module's top level."""
    out = set()
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                for e in ast.walk(t):
                    if isinstance(e, ast.Name):
                        out.add(e.id)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for a in n.names:
                out.add(a.asname or a.name.split(".")[0])
    return out


REF_MODULES = _modules(REF)
PORT_MODULES = _modules(PORT)


@functools.lru_cache(maxsize=None)
def _missing():
    """[(module, name)] of reference names with no counterpart of the same
    module path and name."""
    out = []
    for mod, path in sorted(REF_MODULES.items()):
        names = public_defs(path)
        have = top_level_names(PORT_MODULES[mod]) if mod in PORT_MODULES \
            else set()
        out += [(mod, n) for n in sorted(names - have)]
    return tuple(out)


def _departure(mod, name):
    return DEPARTURES.get(f"{mod}:{name}") or DEPARTURES.get(f"{mod}:*")


@pytest.mark.parametrize("mod", sorted(REF_MODULES))
def test_every_public_name_has_a_counterpart(mod):
    unmatched = [f"{m}:{n}" for m, n in _missing()
                 if m == mod and _departure(m, n) is None]
    assert not unmatched, f"no counterpart in liquid_tpu_torch: {unmatched}"


@pytest.mark.parametrize("key", sorted(DEPARTURES))
def test_departure_targets_exist(key):
    targets, why = DEPARTURES[key]
    assert targets and why
    for t in targets:
        path, _, name = t.partition("::")
        full = os.path.join(PORT, path)
        assert os.path.isfile(full), t
        if name:
            assert name in top_level_names(full), t


@pytest.mark.parametrize("key", sorted(DEPARTURES))
def test_departures_are_still_needed(key):
    """An entry names a reference module (and name) the port really
    lacks: a name the port gains leaves the table."""
    mod, _, name = key.partition(":")
    assert mod in REF_MODULES, key
    missing = {n for m, n in _missing() if m == mod}
    if name == "*":
        assert mod not in PORT_MODULES and missing, key
    else:
        assert name in public_defs(REF_MODULES[mod]), key
        assert name in missing, key


def test_audit_reads_both_trees():
    assert len(REF_MODULES) > 70 and len(PORT_MODULES) > 70
    assert "utils/shuttle.py" in PORT_MODULES
    assert {"bench/micro.py", "bench/stackoverflow_data.py",
            "bench/fuzz.py"} <= set(PORT_MODULES)
