"""k2_roofline (%): K2 (`ops/csrc/group_accumulate.cu`) in the traced
window -- the bytes its launches need (`roofline.k2_bytes`, from the
shapes recorded at `grouphist_cuda.group_accumulate`) at the HBM peak,
over its summed kernel time in the profiler's trace."""
from cachebench import roofline

KERNEL = "group_accumulate_kernel"


def _shapes(a, kw):
    slot = kw.get("slot", a[0] if a else None)
    cols = kw.get("cols", a[1] if len(a) > 1 else None)
    m = kw.get("m", a[2] if len(a) > 2 else None)
    return (slot.numel() * slot.element_size(),
            sum(c.numel() * c.element_size() for c in cols), int(m),
            len(cols))


HOOKS = {("liquid_tpu_torch.ops.grouphist_cuda", "group_accumulate"):
         _shapes}


def read(run):
    calls = [c for key in HOOKS for c in run.hook_calls.get(key, [])]
    ns = sum(e - s for n, s, e in run.device_events if KERNEL in n)
    # a call over no rows launches nothing
    return roofline.share_pct(sum(roofline.k2_bytes(*c) for c in calls
                                  if c[0]), ns / 1e9)
