"""Shredded JSON (variant) columns (port of `liquid_tpu/arrays/variant.py`).

A variant column is JSON text (utf8).  Its squeezed form,
`VariantStructSqueezedArray` (liquid-cache
`src/core/src/liquid_array/variant_array.rs:14-20`), keeps only the
*requested paths*, each shredded into an ordinary typed liquid block
(bit-planes for ints and bools, ALP for floats, a dictionary for
strings), and leaves the whole column on disk as arrow bytes.
`contains_path` answers residency; `to_arrow_with_paths` reads typed
paths with no IO when every requested path is resident; a path asked for
later is merged in by re-shredding from the disk backing
(`merged_with`).  Parsing and shredding are host work, done once per
squeeze; `variant_get` predicates run on the decoded paths.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from liquid_tpu_torch.arrays.base import LiquidSqueezedArray

#: types a shredded path can be requested as (ref variant_get's type arg,
#: reader/variant_udf.rs:120)
PATH_TYPES = ("int64", "float64", "utf8", "bool", "variant")

_SEG_RE = re.compile(r"([^.\[\]]+)|\[(\d+)\]")


def parse_path(path: str) -> Tuple[object, ...]:
    """'a.b[0].c' -> ('a', 'b', 0, 'c').  '$.' prefix is tolerated."""
    if path.startswith("$."):
        path = path[2:]
    elif path.startswith("$"):
        path = path[1:]
    segs: List[object] = []
    for m in _SEG_RE.finditer(path):
        if m.group(1) is not None:
            segs.append(m.group(1))
        else:
            segs.append(int(m.group(2)))
    return tuple(segs)


def get_path(doc, segs: Sequence[object]):
    """Walk a parsed JSON document; -> value or None if absent."""
    cur = doc
    for s in segs:
        if isinstance(s, int):
            if not isinstance(cur, list) or s >= len(cur) or s < -len(cur):
                return None
            cur = cur[s]
        else:
            if not isinstance(cur, dict) or s not in cur:
                return None
            cur = cur[s]
    return cur


def _typed_value(v, type_name: str):
    """Shredding type gate: mismatched values become NULL (typical
    variant-shredding semantics; ref variant typed-get)."""
    if v is None:
        return None
    if type_name == "int64":
        if isinstance(v, bool) or not isinstance(v, int):
            return None
        return v
    if type_name == "float64":
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        return float(v)
    if type_name == "utf8":
        return v if isinstance(v, str) else None
    if type_name == "bool":
        return v if isinstance(v, bool) else None
    # "variant": compact JSON of the subtree
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def arrow_type_of(type_name: str) -> pa.DataType:
    return {"int64": pa.int64(), "float64": pa.float64(), "utf8": pa.string(),
            "bool": pa.bool_(), "variant": pa.string()}[type_name]


def field_name(path: str, type_name: str) -> str:
    return f"{path}:{type_name}"


def parse_docs(arr: pa.Array) -> List[object]:
    """JSON-parse a utf8 variant column once (shared across paths); a
    NULL or a document `json.loads` rejects is None."""
    out: List[object] = []
    for s in arr.to_pylist():
        if s is None:
            out.append(None)
            continue
        try:
            out.append(json.loads(s))
        except (ValueError, TypeError):
            out.append(None)
    return out


def extract_paths(docs: List[object],
                  requests: Sequence[Tuple[str, str]]) -> pa.StructArray:
    """-> StructArray with one typed field per (path, type) request."""
    fields, children = [], []
    for path, type_name in requests:
        segs = parse_path(path)
        vals = [_typed_value(get_path(d, segs), type_name)
                if d is not None else None for d in docs]
        t = arrow_type_of(type_name)
        fields.append(pa.field(field_name(path, type_name), t))
        children.append(pa.array(vals, type=t))
    return pa.StructArray.from_arrays(children, fields=fields)


def contains_path_docs(docs: List[object], path: str) -> pa.Array:
    """Per-row boolean: does the document contain `path`
    (ref `contains_path`, variant_array.rs)."""
    segs = parse_path(path)
    out = []
    for d in docs:
        if d is None:
            out.append(None)
        else:
            # distinguish "present with null value" from "absent"
            out.append(_path_present(d, segs))
    return pa.array(out, type=pa.bool_())


def _path_present(doc, segs) -> bool:
    cur = doc
    for s in segs:
        if isinstance(s, int):
            if not isinstance(cur, list) or not (-len(cur) <= s < len(cur)):
                return False
        else:
            if not isinstance(cur, dict) or s not in cur:
                return False
        cur = cur[s]
    return True


class VariantStructSqueezedArray(LiquidSqueezedArray):
    """Requested paths shredded + liquid-encoded in memory; full JSON
    column on disk (arrow bytes).

    Ref variant_array.rs:14-20: `{paths: HashMap<path, LiquidArrayRef>,
    disk backing = full variant struct}`.
    """

    def __init__(self, shredded: Dict[Tuple[str, str], object], length: int,
                 disk_range=None):
        self.shredded = shredded      # (path, type) -> LiquidArray
        self.length = length
        self.arrow_type = pa.string()
        self._disk_range = disk_range

    def memory_bytes(self) -> int:
        return sum(a.memory_bytes() for a in self.shredded.values()) + 64

    def disk_backing(self):
        # full column is stored as arrow bytes, not liquid IPC
        # (ref SqueezedBacking::Arrow, mod.rs:156-170)
        return ("arrow", self._disk_range)

    def contains_path(self, path: str, type_name: str) -> bool:
        return (path, type_name) in self.shredded

    def resident_requests(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(self.shredded.keys())

    def to_arrow(self, io) -> pa.Array:
        from liquid_tpu_torch.arrays.ipc import arrow_from_bytes
        return arrow_from_bytes(io.read(self._disk_range))

    def to_arrow_with_paths(self, requests: Sequence[Tuple[str, str]], io
                            ) -> Tuple[pa.StructArray, bool]:
        """-> (struct of typed path columns, used_io).  Zero IO iff every
        request is resident (ref to_arrow_array_with_paths + the
        all-paths-resident shortcut, core.rs:747-788)."""
        if all((p, t) in self.shredded for p, t in requests):
            fields, children = [], []
            for p, t in requests:
                # a string path decodes as a dictionary: read it as the
                # path's own type, as a parse of the JSON gives it
                arr = self.shredded[(p, t)].to_arrow().cast(arrow_type_of(t))
                fields.append(pa.field(field_name(p, t), arr.type))
                children.append(arr)
            return pa.StructArray.from_arrays(children, fields=fields), False
        docs = parse_docs(self.to_arrow(io))
        return extract_paths(docs, requests), True

    def merged_with(self, requests: Sequence[Tuple[str, str]], io
                    ) -> "VariantStructSqueezedArray":
        """Re-shred from disk with the union of resident + requested paths
        (ref merge of newly-requested variant paths, hydration.rs:147-160)."""
        want = list(dict.fromkeys(list(self.shredded.keys()) + list(requests)))
        docs = parse_docs(self.to_arrow(io))
        sq = shred_from_docs(docs, want, self.length)
        sq._disk_range = self._disk_range
        return sq


def shred_from_docs(docs: List[object], requests: Sequence[Tuple[str, str]],
                    length: int) -> VariantStructSqueezedArray:
    from liquid_tpu_torch.cache import transcode as tc
    struct = extract_paths(docs, requests)
    shredded: Dict[Tuple[str, str], object] = {}
    for (p, t) in requests:
        child = struct.field(field_name(p, t))
        liquid = tc.transcode(child)
        if liquid is None:
            continue  # untranscodable path type: not kept resident
        shredded[(p, t)] = liquid
    return VariantStructSqueezedArray(shredded, length)


def shred_variant(arr: pa.Array, requests: Sequence[Tuple[str, str]]
                  ) -> Optional[Tuple[VariantStructSqueezedArray, bytes]]:
    """Arrow utf8 JSON column + requested paths ->
    (squeezed variant, full-column arrow bytes to write to disk).

    Ref try_variant_squeeze (policies/squeeze.rs:222-290).
    """
    if not (pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type)
            or pa.types.is_string_view(arr.type)):
        return None
    from liquid_tpu_torch.arrays.ipc import arrow_to_bytes
    docs = parse_docs(arr)
    sq = shred_from_docs(docs, list(requests), len(arr))
    return sq, arrow_to_bytes(arr)
