"""K4's fused form (`bitpack_cuda.select_planes`), the mesh's shard
selection, on the CPU.

- `select_planes_ref`, and `select_planes` on CPU tensors, against the
  reference's chain: `liquid_tpu.ops.bitpack.cmp_const_op` per
  predicate, ANDed into the selection and then with the column's
  validity, as `liquid_tpu/parallel/session.py::_selection_body` does.
  Inputs from seeded numpy: widths 0..64 mixed within one call, P = 1,
  2, 5, 16 and 17 predicates, every op, interval pairs (two predicates
  on one column's planes), validity present and absent, W of 1, 255
  and 1,001 words, constants 0, 2^w - 1, 2^w, 2^64 - 1 and one inside
  the width.
- The wrapper's contract: each bad input raises, a CPU tensor counts no
  launch, and the launch plan (`select_launches`): one launch per 16
  descriptors, a column's two bounds sharing one.
- The mesh: distributed TPC-H q6 (SF 0.005) and TPC-DS q37 (SF 0.05)
  on eight CPU shards give the reference's answers (q6: its
  `DistributedSession` on its 8-device virtual mesh; q37: its own q37
  oracle, `tpcds_ref`), and `DIAG["k4_planned"]` counts one launch per
  shard per table scan with a bit-plane predicate.

Masks are integers: bit-exact (tolerance 0); the SQL answers' floats
rtol 1e-9.  The CUDA kernel itself is held against `select_planes_ref`
on the card by `chip_smoke.py` (phase 4b)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from liquid_tpu.ops import bitpack as jbp  # noqa: E402
from liquid_tpu_torch.bench import oracle, tpcds_data, tpcds_queries  # noqa: E402
from liquid_tpu_torch.bench import tpch_data, tpch_queries  # noqa: E402
from liquid_tpu_torch.device import words_to_numpy, words_to_tensor  # noqa: E402
from liquid_tpu_torch.ops import bitpack_cuda as k  # noqa: E402
from liquid_tpu_torch.parallel import dist, make_mesh  # noqa: E402
from liquid_tpu_torch.parallel.session import DistributedSession  # noqa: E402

OPS = k.SELECT_OPS
#: an interval's two ops: lower bound first
PAIRS = (("gt_eq", "lt_eq"), ("gt", "lt"), ("gt_eq", "lt"), ("gt", "lt_eq"),
         ("ne", "lt_eq"), ("eq", "gt_eq"))


def _constants(width: int, rng) -> list:
    top = (1 << width) - 1
    out = [0, top, (1 << 64) - 1,
           int(rng.integers(0, top + 1, dtype=np.uint64))]
    if width < 64:
        out.append(1 << width)
    return out


def _case(n_words: int, n_preds: int, seed: int):
    """(sel, [(planes, c, op, valid)]) as numpy uint32 words: widths from
    a run through 0..64 offset by the seed, every third predicate the
    second bound of an interval on the one before's column."""
    rng = np.random.default_rng(seed)
    # most rows selected, so a wrong predicate shows
    sel = ~(rng.integers(0, 1 << 32, n_words, dtype=np.uint64)
            & rng.integers(0, 1 << 32, n_words, dtype=np.uint64)
            & rng.integers(0, 1 << 32, n_words, dtype=np.uint64)
            ).astype(np.uint32)
    preds = []
    for i in range(n_preds):
        if i % 3 == 2:
            planes, _c, _op, valid = preds[-1]
            width = planes.shape[0]
            lo_op, hi_op = PAIRS[(seed + i) % len(PAIRS)]
            pool = _constants(width, rng)
            lo, hi = sorted(pool[j] for j in rng.choice(len(pool), 2))
            preds[-1] = (planes, lo, lo_op, valid)
            preds.append((planes, hi, hi_op, valid))
            continue
        width = (seed * 7 + i * 13) % 65
        planes = rng.integers(0, 1 << 32, (width, n_words), dtype=np.uint64
                              ).astype(np.uint32)
        pool = _constants(width, rng)
        c = pool[(seed + i) % len(pool)]
        valid = None
        if i % 2:
            valid = ~(rng.integers(0, 1 << 32, n_words, dtype=np.uint64)
                      & rng.integers(0, 1 << 32, n_words, dtype=np.uint64)
                      ).astype(np.uint32)
        preds.append((planes, c, OPS[(seed + i) % len(OPS)], valid))
    return sel, preds


def _reference(sel: np.ndarray, preds) -> np.ndarray:
    """The reference's chain: `cmp_const_op` per predicate, then the
    column's validity, ANDed into sel in turn."""
    out = jnp.asarray(sel)
    for planes, c, op, valid in preds:
        out = out & jbp.cmp_const_op(jnp.asarray(planes), jnp.uint64(c), op)
        if valid is not None:
            out = out & jnp.asarray(valid)
    return np.asarray(out)


def _torch_preds(preds):
    """The same predicates as tensors, one tensor per distinct column."""
    seen = {}

    def t(a):
        if a is None:
            return None
        if id(a) not in seen:
            seen[id(a)] = words_to_tensor(a)
        return seen[id(a)]

    return [(t(p), c, op, t(v)) for p, c, op, v in preds]


CASES = [(n_words, n_preds) for n_words in (1, 255, 1001)
         for n_preds in (1, 2, 5, 16, 17)]


@pytest.mark.parametrize("n_words,n_preds", CASES,
                         ids=[f"W{w}-P{p}" for w, p in CASES])
def test_matches_reference_chain(n_words, n_preds):
    seed = n_words * 31 + n_preds
    sel, preds = _case(n_words, n_preds, seed)
    want = _reference(sel, preds)
    tsel, tpreds = words_to_tensor(sel), _torch_preds(preds)
    before = dict(k.LAUNCHES)
    for fn in (k.select_planes_ref, k.select_planes):
        got = fn(tsel, tpreds)
        assert got.dtype == torch.int32 and got.shape == (n_words,)
        np.testing.assert_array_equal(words_to_numpy(got), want)
    # sel is not written; a CPU tensor launches nothing
    np.testing.assert_array_equal(words_to_numpy(tsel), sel)
    assert k.LAUNCHES == before


#: widths whose lone predicate is checked under every op (the rest
#: under one op each: the reference compiles once per width and op)
ALL_OPS_WIDTHS = (0, 12, 64)


def test_every_width_and_constant_alone():
    """Each width 0..64 and constant of the pool as a lone predicate, flat
    and prepped planes, with and without validity: one op per width, all
    six at `ALL_OPS_WIDTHS`."""
    rng = np.random.default_rng(64)
    n_words = 128
    sel = np.full(n_words, 0xFFFFFFFF, np.uint32)
    valid = rng.integers(0, 1 << 32, n_words, dtype=np.uint64
                         ).astype(np.uint32)
    tsel, tvalid = words_to_tensor(sel), words_to_tensor(valid)
    for width in range(65):
        planes = rng.integers(0, 1 << 32, (width, n_words), dtype=np.uint64
                              ).astype(np.uint32)
        tplanes = words_to_tensor(planes)
        ops = OPS if width in ALL_OPS_WIDTHS else (OPS[width % len(OPS)],)
        for c in _constants(width, rng):
            for op in ops:
                for v, tv in ((None, None), (valid, tvalid)):
                    want = _reference(sel, [(planes, c, op, v)])
                    for form in (tplanes, k.prep(tplanes)):
                        got = k.select_planes(tsel, [(form, c, op, tv)])
                        np.testing.assert_array_equal(
                            words_to_numpy(got), want,
                            err_msg=f"w {width} c {c} {op}")


def test_no_predicates_and_no_rows():
    sel = torch.tensor([-1, 5], dtype=torch.int32)
    got = k.select_planes(sel, [])
    assert got.tolist() == [-1, 5] and got.data_ptr() != sel.data_ptr()
    assert k.select_launches(sel, []) == 0
    empty = torch.zeros(0, dtype=torch.int32)
    preds = [(torch.zeros((3, 0), dtype=torch.int32), 1, "lt", None)]
    assert k.select_planes(empty, preds).shape == (0,)
    assert k.select_launches(empty, preds) == 0


def _col(width, n_words, seed):
    rng = np.random.default_rng(seed)
    return words_to_tensor(rng.integers(0, 1 << 32, (width, n_words),
                                        dtype=np.uint64).astype(np.uint32))


def test_launch_plan():
    n_words = 64
    sel = torch.full((n_words,), -1, dtype=torch.int32)
    cols = [_col(1 + i % 20, n_words, i) for i in range(20)]
    valid = torch.full((n_words,), -1, dtype=torch.int32)

    def lone(n):
        return [(cols[i], 1, "gt", None) for i in range(n)]

    assert [k.select_launches(sel, lone(n)) for n in (1, 2, 5, 16, 17)] \
        == [1, 1, 1, 1, 2]
    assert k.select_launches(sel, lone(20)) == 2
    # two bounds on one column share a descriptor: 16 intervals, 1 launch
    pairs = [(c, lo, op, valid) for c in cols[:16]
             for lo, op in ((1, "gt_eq"), (5, "lt"))]
    assert k.select_launches(sel, pairs) == 1
    # a third bound on the column opens a second descriptor; another
    # validity is another column
    three = [(cols[0], c, "ne", valid) for c in (1, 2, 3)]
    assert len(k._descriptors(three)) == 2
    other = [(cols[0], 1, "gt", valid), (cols[0], 2, "lt", None)]
    assert len(k._descriptors(other)) == 2
    # the mesh's count is the wrapper's plan
    assert dist.k4_launches(sel, pairs + lone(1)) == 2


def test_chained_case_matches_reference():
    """17 descriptors: two chained launches on the card; the plain
    version's answer is the reference's."""
    sel, preds = _case(96, 17, 5)
    tsel, tpreds = words_to_tensor(sel), _torch_preds(preds)
    descs = k._descriptors(tpreds)
    assert len(descs) == 17 - len([i for i in range(17) if i % 3 == 2])
    np.testing.assert_array_equal(words_to_numpy(k.select_planes(
        tsel, tpreds)), _reference(sel, preds))
    wide = [(_col(i % 65, 96, i), i, OPS[i % 6], None) for i in range(17)]
    assert k.select_launches(tsel, wide) == 2


def test_rejects_bad_inputs():
    n_words = 256
    sel = torch.full((n_words,), -1, dtype=torch.int32)
    planes = _col(5, n_words, 1)
    ok = (planes, 3, "lt", None)
    k.select_planes(sel, [ok])
    bad_calls = [
        (sel.to(torch.int64), [ok]),
        (sel[None], [ok]),
        (sel[::2], [(planes[:, ::2].contiguous(), 3, "lt", None)]),
        (sel, [(planes.to(torch.int64), 3, "lt", None)]),
        (sel, [(planes.t().contiguous().t(), 3, "lt", None)]),
        (sel, [(planes[:, :128].contiguous(), 3, "lt", None)]),
        (sel, [(_col(65, n_words, 2), 3, "lt", None)]),
        (sel, [(planes, 3, "le", None)]),
        (sel, [(planes, -1, "lt", None)]),
        (sel, [(planes, 1 << 64, "lt", None)]),
        (sel, [(planes, 3.0, "lt", None)]),
        (sel, [(planes, 3, "lt")]),
        (sel, [(planes, 3, "lt", sel[:128].contiguous())]),
        (sel, [(planes, 3, "lt", sel.to(torch.int64))]),
        (sel, [(planes, 3, "lt", torch.stack([sel, sel], 1)[:, 0])]),
        (sel, [(planes.to("meta"), 3, "lt", None)]),
        (sel, [(planes, 3, "lt", sel.to("meta"))]),
        (sel.to("meta"), [(planes.to("meta"), 3, "lt", None)]),
    ]
    for fn in (k.select_planes, k.select_planes_ref):
        for s, preds in bad_calls:
            with pytest.raises((TypeError, ValueError)):
                fn(s, preds)


# -- the mesh: TPC-H q6 and TPC-DS q37 on eight CPU shards -------------------------------

N_SHARDS = 8
#: K4 launches per run on eight shards: one per shard per table scan with
#: a bit-plane predicate (q6: lineitem's l_shipdate interval; q37:
#: inventory's quantity interval and date_dim's date interval), against
#: one per shard per predicate (16 and 32) before the fused form
K4_PER_RUN = {"tpch_q6": N_SHARDS, "ds_q37": 2 * N_SHARDS}


@pytest.fixture(scope="module")
def tables():
    # TPC-DS at SF 0.05: q37 answers no row at SF 0.005
    return {"tpch_q6": {"lineitem": tpch_data.generate(0.005)["lineitem"]},
            "ds_q37": tpcds_data.generate(0.05)}


def _reference_answer(name, tabs, sql):
    """tpch_q6: the reference's `DistributedSession` on its 8-device
    virtual mesh.  ds_q37: the reference's own q37 oracle
    (`liquid_tpu.bench.tpcds_ref`), since its session compiles q37's join
    shape for minutes on the CPU."""
    if name == "ds_q37":
        from liquid_tpu.bench import tpcds_ref
        import pyarrow as pa
        ref = tpcds_ref.REFS[37](tpcds_ref.to_pandas_tables(tabs))
        return pa.Table.from_pandas(ref.reset_index(drop=True),
                                    preserve_index=False)
    from liquid_tpu.parallel.session import DistributedSession as JSession
    ref = JSession()
    for t, tab in tabs.items():
        ref.register_table(t, tab)
    want = ref.sql(sql)
    assert ref.route_stats["fallback"] == 0
    return want


@pytest.mark.parametrize("name", sorted(K4_PER_RUN))
def test_mesh_matches_reference(tables, name, monkeypatch):
    monkeypatch.setenv("LIQUID_DIST_STRICT", "1")
    sql = tpch_queries.QUERIES[6] if name == "tpch_q6" \
        else tpcds_queries.QUERIES[37]
    sess = DistributedSession(make_mesh(devices=["cpu"] * N_SHARDS))
    for t, tab in tables[name].items():
        sess.register_table(t, tab)
    calls = []
    select = k.select_planes

    def counted(sel, preds):
        calls.append(len(preds))
        return select(sel, preds)

    monkeypatch.setattr(k, "select_planes", counted)
    got = sess.sql(sql)
    want = _reference_answer(name, tables[name], sql)
    assert sess.route_stats == {"distributed": 1, "fallback": 0,
                                "fallback_reasons": []}
    assert got.num_rows > 0 and got.num_rows == want.num_rows
    assert oracle.same_table(got, want.columns)
    assert dist.DIAG["k4_planned"] == K4_PER_RUN[name] == len(calls)
    # the old plan's count: one launch per shard per predicate
    assert sum(calls) == 2 * K4_PER_RUN[name]
