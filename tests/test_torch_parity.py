"""Completeness audit: every public function, class, class member,
parameter and module constant of the JAX package has a counterpart in
the port.

Read with `ast`, importing neither package.  For every
`liquid_tpu/**/*.py` and the module of the same path under
`liquid_tpu_torch/`:
- each public top-level `def` / `class` must be defined (or imported,
  or assigned) at the port module's top level;
- each public member of a class the port module also defines (a method,
  property, class attribute or dataclass field) must be a member of the
  port's class: one of those, an attribute its `__init__` assigns, or a
  member of a port base class resolved by name;
- each named parameter of a public function, or of a public method (or
  `__init__`) of such a class, must be a parameter of the port's;
- each public UPPER_CASE name bound at the module's top level must be
  bound at the port module's.
Each gap needs an entry in `DEPARTURES`, keyed `"module:name"` (a
function, class or constant; `"module:*"` the whole module),
`"module:Class.member"` or `"module:func(param)"` /
`"module:Class.method(param)"`, which maps it to the port's files or
`file::name`s (`name` may be `Class.member`) that do that work, and
says why; each target must exist.  An entry is kept only while the port
lacks the name, so the table is the whole list of departures.
"""
import ast
import functools
import os
import re

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
    "utils/tracing.py:Tracer.export_otlp": (
        ("utils/tracing.py::Tracer.export_chrome_trace",),
        "the reference's OTLP export sends nothing (False without the "
        "opentelemetry package, NotImplementedError with it); spans leave "
        "the process as Chrome trace-event JSON"),
    "sql/fused_agg.py:eval_ir": (
        ("sql/fused_agg.py::eval_ir_nulls",),
        "one three-valued evaluator: values and NULL masks together"),
    "sql/fused_agg.py:release_prep_cache": (
        ("sql/fused_agg.py::TableState.release",
         "sql/fused_agg.py::table_state"),
        "a table's fused-route memos are one state object: releasing it "
        "gives back the preps' budget and the builds' reservations"),
    # device properties: a block's fields stay on the host and each
    # method takes the device it runs on
    **{f"{mod}:{cls}.{attr}": (
        (f"{mod}::{cls}.{attr}_np", f"{mod}::{cls}.to_device"),
        f"the host words; `to_device(device)` or a method's `device` "
        f"puts them on a device (the reference's `{attr}` is a JAX "
        f"device array)")
       for mod, cls, attrs in (
           ("arrays/primitive.py", "LiquidPrimitiveArray",
            ("planes", "validity")),
           ("arrays/float_alp.py", "LiquidFloatArray",
            ("planes", "validity")),
           ("arrays/byteview.py", "LiquidByteViewArray",
            ("codes", "validity")),
           ("arrays/linear.py", "LiquidLinearArray", ("validity",)),
           ("arrays/linear.py", "LiquidPrimitiveDeltaArray",
            ("validity",)))
       for attr in attrs},
    # parameters the reference never reads
    **{f"{mod}:{cls}.try_eval_predicate(selection)": (
        (f"{mod}::{cls}.try_eval_predicate",),
        "never read by the reference: a result covers every row and the "
        "caller ANDs its selection; the port's `device` names where the "
        "mask is made")
       for mod, cls in (
           ("arrays/base.py", "LiquidArray"),
           ("arrays/primitive.py", "LiquidPrimitiveArray"),
           ("arrays/float_alp.py", "LiquidFloatArray"),
           ("arrays/byteview.py", "LiquidByteViewArray"),
           ("arrays/decimal.py", "LiquidDecimalArray"),
           ("arrays/decimal.py", "LiquidFixedLenByteArray"),
           ("arrays/linear.py", "LiquidLinearArray"),
           ("arrays/linear.py", "LiquidPrimitiveDeltaArray"))},
    "cache/core.py:LiquidCache.eval_predicate(selection)": (
        ("cache/core.py::LiquidCache.eval_predicate",),
        "only handed to `try_eval_predicate`, which never reads it"),
    "cache/core.py:LiquidCache.get(expression_hint)": (
        ("cache/core.py::LiquidCache.get",),
        "only handed to `_read_arrow`, which never reads it"),
    "sql/physical.py:scan_blocks(observer)": (
        ("sql/physical.py::scan_blocks",),
        "never read by the reference: the cache's own observer counts "
        "the scan"),
    # the list-of-parts collectives: a sharded value is a list of
    # per-shard tensors, reduced onto the first shard's device
    **{f"parallel/dist.py:{f}({p})": (
        (f"parallel/dist.py::{f}",),
        "takes the shards' parts; the mesh has one axis, so no name")
       for f in ("psum", "pmin", "pmax") for p in ("x", "axis")},
    # the engine's decoders travel as one environment
    **{f"sql/fused_agg.py:eval_ir_nulls({p})": (
        ("sql/fused_agg.py::eval_ir_nulls", "sql/fused_agg.py::_Decoders"),
        "`env.decode` and `env.nulls` in one environment")
       for p in ("col", "nul")},
    **{f"sql/fused_agg.py:probe_dims({p})": (
        ("sql/fused_agg.py::probe_dims", "sql/fused_agg.py::_Decoders"),
        "`env.decode`, `env.nulls` and `env.probe_j` in one environment")
       for p in ("decode", "col_nulls", "probe_j")},
    # JAX's sharding names
    **{f"{mod}:P": (("parallel/dist.py::shard_rows",
                     "parallel/dist.py::replicate"),
                    "JAX's PartitionSpec: a sharded value is a list of "
                    "per-shard tensors")
       for mod in ("parallel/dist.py", "parallel/join.py",
                   "parallel/session.py")},
    **{f"{mod}:DATA_AXIS": (("parallel/dist.py::Mesh.devices",),
                            "a JAX mesh axis name for PartitionSpecs and "
                            "collectives; the port's mesh has one axis, "
                            "a shard is an index into `Mesh.devices`")
       for mod in ("parallel/__init__.py", "parallel/dist.py")},
    "parallel/join.py:AGG_FUNCS": (
        ("sql/physical.py::AGG_FUNCS",),
        "imported by the reference's join.py and never read there"),
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


# -- classes, parameters and constants ------------------------------------

def _defs(body):
    return {n.name: n for n in body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def classes(path):
    return {n.name: n for n in _tree(path).body
            if isinstance(n, ast.ClassDef)}


def class_members(node, init_attrs=False):
    """A class body's methods, properties, class attributes and dataclass
    fields; with `init_attrs`, also the `self.x` its `__init__` assigns."""
    out = set(_defs(node.body))
    for n in node.body:
        if isinstance(n, ast.Assign):
            out |= {e.id for t in n.targets for e in ast.walk(t)
                    if isinstance(e, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    init = _defs(node.body).get("__init__")
    if init_attrs and init is not None:
        out |= {e.attr for e in ast.walk(init)
                if isinstance(e, ast.Attribute)
                and isinstance(e.ctx, ast.Store)
                and isinstance(e.value, ast.Name) and e.value.id == "self"}
    return out


def _port_module_of(dotted):
    """'liquid_tpu_torch.a.b' -> the port module path 'a/b.py' (or
    'a/b/__init__.py'), or None outside the port."""
    head, _, rest = dotted.partition(".")
    if head != "liquid_tpu_torch" or not rest:
        return None
    base = rest.replace(".", "/")
    for cand in (f"{base}.py", f"{base}/__init__.py"):
        if cand in PORT_MODULES:
            return cand
    return None


def _imported(mod, alias):
    """What a port module's top-level import binds to `alias`:
    (port module, name or None for the module itself), or None."""
    for n in _tree(PORT_MODULES[mod]).body:
        if isinstance(n, ast.ImportFrom) and n.module:
            for a in n.names:
                if (a.asname or a.name) != alias:
                    continue
                sub = _port_module_of(f"{n.module}.{a.name}")
                if sub is not None:
                    return sub, None
                owner = _port_module_of(n.module)
                return (owner, a.name) if owner else None
        elif isinstance(n, ast.Import):
            for a in n.names:
                if a.asname == alias:
                    sub = _port_module_of(a.name)
                    return (sub, None) if sub else None
    return None


@functools.lru_cache(maxsize=None)
def port_class(mod, name):
    """(module, ClassDef) of a class a port module defines or imports by
    `name`, or None."""
    if mod not in PORT_MODULES:
        return None
    node = classes(PORT_MODULES[mod]).get(name)
    if node is not None:
        return mod, node
    imp = _imported(mod, name)
    return port_class(*imp) if imp and imp[1] else None


def _base_classes(mod, node):
    for b in node.bases:
        if isinstance(b, ast.Name):
            found = port_class(mod, b.id)
        elif isinstance(b, ast.Attribute) and isinstance(b.value, ast.Name):
            imp = _imported(mod, b.value.id)
            found = port_class(imp[0], b.attr) if imp and not imp[1] \
                else None
        else:
            found = None
        if found is not None:
            yield found


def _port_class_defs(mod, name):
    """The port class and every base the audit resolves, nearest first."""
    out, todo = [], [port_class(mod, name)]
    while todo:
        c = todo.pop(0)
        if c is not None and c not in out:
            out.append(c)
            todo += list(_base_classes(*c))
    return out


def port_members(mod, name):
    out = set()
    for _m, node in _port_class_defs(mod, name):
        out |= class_members(node, init_attrs=True)
    return out


def _port_method(mod, cls, meth):
    for _m, node in _port_class_defs(mod, cls):
        f = _defs(node.body).get(meth)
        if f is not None:
            return f
    return None


def params(f):
    a = f.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _public(name):
    return not name.startswith("_")


CLASS_PAIRS = sorted(
    f"{mod}:{c}" for mod, path in REF_MODULES.items() if mod in PORT_MODULES
    for c in classes(path) if _public(c) and port_class(mod, c) is not None)


def member_gaps(pair):
    """Public members of the reference class with no port counterpart."""
    mod, cls = pair.split(":")
    ref = {m for m in class_members(classes(REF_MODULES[mod])[cls])
           if _public(m)}
    return sorted(ref - port_members(mod, cls))


def _signature_pairs(mod):
    """(key prefix, reference def, port def) of the public functions and
    of the public methods and `__init__` of the class pairs."""
    ref, port = REF_MODULES[mod], PORT_MODULES[mod]
    pdefs = _defs(_tree(port).body)
    for name, f in _defs(_tree(ref).body).items():
        if _public(name) and name in pdefs:
            yield name, f, pdefs[name]
    for pair in CLASS_PAIRS:
        m, cls = pair.split(":")
        if m != mod:
            continue
        for name, f in _defs(classes(ref)[cls].body).items():
            pf = _port_method(mod, cls, name)
            if (_public(name) or name == "__init__") and pf is not None:
                yield f"{cls}.{name}", f, pf


def param_gaps(mod):
    return [f"{prefix}({p})" for prefix, f, pf in _signature_pairs(mod)
            for p in params(f) if p not in params(pf)]


_CONSTANT = re.compile(r"[A-Z][A-Z0-9_]*$")


def constants(path):
    return {n for n in top_level_names(path) if _CONSTANT.match(n)}


def constant_gaps(mod):
    return sorted(constants(REF_MODULES[mod])
                  - top_level_names(PORT_MODULES[mod]))


SHARED = sorted(m for m in REF_MODULES if m in PORT_MODULES)


def _undeparted(mod, gaps):
    return [f"{mod}:{g}" for g in gaps if f"{mod}:{g}" not in DEPARTURES]


# -- tests -----------------------------------------------------------------

@pytest.mark.parametrize("mod", sorted(REF_MODULES))
def test_every_public_name_has_a_counterpart(mod):
    unmatched = [f"{m}:{n}" for m, n in _missing()
                 if m == mod and _departure(m, n) is None]
    assert not unmatched, f"no counterpart in liquid_tpu_torch: {unmatched}"


@pytest.mark.parametrize("pair", CLASS_PAIRS)
def test_every_class_member_has_a_counterpart(pair):
    mod, cls = pair.split(":")
    unmatched = _undeparted(mod, [f"{cls}.{m}" for m in member_gaps(pair)])
    assert not unmatched, f"no member in liquid_tpu_torch: {unmatched}"


@pytest.mark.parametrize("mod", SHARED)
def test_every_parameter_has_a_counterpart(mod):
    unmatched = _undeparted(mod, param_gaps(mod))
    assert not unmatched, f"no parameter in liquid_tpu_torch: {unmatched}"


@pytest.mark.parametrize("mod", SHARED)
def test_every_public_constant_has_a_counterpart(mod):
    unmatched = _undeparted(mod, constant_gaps(mod))
    assert not unmatched, f"no constant in liquid_tpu_torch: {unmatched}"


def _target_exists(path, name):
    full = os.path.join(PORT, path)
    if not os.path.isfile(full):
        return False
    if not name:
        return True
    cls, _, member = name.partition(".")
    if not member:
        return cls in top_level_names(full)
    return member in port_members(path, cls)


@pytest.mark.parametrize("key", sorted(DEPARTURES))
def test_departure_targets_exist(key):
    targets, why = DEPARTURES[key]
    assert targets and why
    for t in targets:
        path, _, name = t.partition("::")
        assert _target_exists(path, name), t


def _still_missing(mod, name):
    """Whether the port still lacks a departure's reference name."""
    if name.endswith(")"):
        return name in param_gaps(mod)
    if "." in name:
        cls = name.partition(".")[0]
        return f"{mod}:{cls}" in CLASS_PAIRS and name in [
            f"{cls}.{m}" for m in member_gaps(f"{mod}:{cls}")]
    if _CONSTANT.match(name) and name in constants(REF_MODULES[mod]):
        return mod in PORT_MODULES and name in constant_gaps(mod)
    return name in public_defs(REF_MODULES[mod]) and \
        name in {n for m, n in _missing() if m == mod}


@pytest.mark.parametrize("key", sorted(DEPARTURES))
def test_departures_are_still_needed(key):
    """An entry names a reference module (and name, member, parameter or
    constant) the port really lacks: a name the port gains leaves the
    table."""
    mod, _, name = key.partition(":")
    assert mod in REF_MODULES, key
    if name == "*":
        missing = {n for m, n in _missing() if m == mod}
        assert mod not in PORT_MODULES and missing, key
    else:
        assert _still_missing(mod, name), key


def test_audit_reads_both_trees():
    assert len(REF_MODULES) > 70 and len(PORT_MODULES) > 70
    assert "utils/shuttle.py" in PORT_MODULES
    assert {"bench/micro.py", "bench/stackoverflow_data.py",
            "bench/fuzz.py"} <= set(PORT_MODULES)
    # the member, parameter and constant audits see what they must
    assert len(CLASS_PAIRS) > 100
    assert "arrays/base.py:LiquidArray" in CLASS_PAIRS
    assert {"planes_np", "validity_np", "filter"} <= port_members(
        "arrays/primitive.py", "LiquidPrimitiveArray")
    assert "SqueezedFloatArray.filter(io)" not in param_gaps(
        "arrays/float_alp.py")
    assert "BLOCK_ROWS" in constants(REF_MODULES["arrays/__init__.py"])
