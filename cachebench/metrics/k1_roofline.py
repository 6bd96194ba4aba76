"""k1_roofline (%): K1 (`ops/csrc/cmp_const_many.cu`) in the traced
window -- the bytes its launches' inputs need (`roofline.k1_bytes`, from
the shapes recorded at `bitpack_cuda.in_interval_many` and
`cmp_const_many`) at the HBM peak, over its summed kernel time in the
profiler's trace."""
from cachebench import roofline

MODULE = "liquid_tpu_torch.ops.bitpack_cuda"
KERNEL = "cmp_const_many_kernel"


def _interval(a, kw):
    b, w, _ = (kw.get("planes_stack", a[0] if a else None)).shape
    return int(b), int(w), True


def _single(a, kw):
    b, w, _ = (kw.get("planes_stack", a[0] if a else None)).shape
    return int(b), int(w), False


HOOKS = {(MODULE, "in_interval_many"): _interval,
         (MODULE, "cmp_const_many"): _single}


def read(run):
    calls = [c for key in HOOKS for c in run.hook_calls.get(key, [])]
    ns = sum(e - s for n, s, e in run.device_events if KERNEL in n)
    # a call over no blocks or no planes launches nothing
    return roofline.share_pct(sum(roofline.k1_bytes(*c) for c in calls
                                  if c[0] and c[1]), ns / 1e9)
