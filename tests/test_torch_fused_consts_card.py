"""On the card: a traced warm run of one fused query (TPC-H q1) and one
star query (q3) enqueues its program with no upload -- no `wait.upload`
span inside a `fused.issue` span, every `fused.issue` span's `uploads`
0 -- so nothing synchronizes the stream while the host enqueues.  Run on
a machine with a card:
`python -m pytest tests/test_torch_fused_consts_card.py -m card --noconftest -p no:cacheprovider`."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cachebench import spec  # noqa: E402
from liquid_tpu_torch.bench import tpch_data  # noqa: E402
from liquid_tpu_torch.sql import fused_agg  # noqa: E402
from liquid_tpu_torch.sql.session import LiquidCacheLocalBuilder  # noqa: E402
from liquid_tpu_torch.utils.tracing import TRACER  # noqa: E402

SF = 0.05


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def ctx(card, tmp_path_factory):
    d = tmp_path_factory.mktemp("fused_consts_card")
    c, _ = LiquidCacheLocalBuilder().with_max_memory_bytes(1 << 32).build()
    for name, path in tpch_data.write_parquet(tpch_data.generate(SF),
                                              str(d)).items():
        c.register_parquet(name, path)
    return c


@pytest.mark.card
@pytest.mark.parametrize("q,route", [("q1", "fused"), ("q3", "star")])
def test_a_warm_program_enqueues_no_upload(ctx, q, route):
    sql = spec.query_sql("tpch_sf1", q)
    warm = [ctx.sql(sql).to_arrow() for _ in range(2)]
    i0 = fused_agg.STATS["issue_uploads"]
    TRACER.reset()
    TRACER.enable()
    try:
        out = ctx.sql(sql).to_arrow()
        torch.cuda.synchronize()
    finally:
        TRACER.disable()
    spans = TRACER.spans()
    TRACER.reset()
    assert out.equals(warm[-1]) and out.num_rows > 0
    byid = {s.span_id: s for s in spans}
    (ex,) = [s for s in spans if s.name == "sql.execute"]
    assert ex.attrs["route"] == route
    issues = [s for s in spans if s.name == "fused.issue"]
    assert issues and all(s.attrs["uploads"] == 0 for s in issues)
    for s in spans:
        if s.name != "wait.upload":
            continue
        p = byid.get(s.parent_id)
        while p is not None:
            assert p.name != "fused.issue", "an upload inside fused.issue"
            p = byid.get(p.parent_id)
    assert fused_agg.STATS["issue_uploads"] == i0
