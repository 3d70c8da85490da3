"""``simstep_roofline_pct``: the least time of the simstep launches in
the profiled calls over the device time of their kernels in the trace,
in percent.  A launch's least time is the larger of its bytes
(``simstep_bytes.launch_bytes`` of the call's slot layout) at the card's
HBM rate and its float operations at the card's f32 rate; the bytes
bound it, by some twenty times."""
import re

from simbench import simstep_bytes as sb


def _kernel(name: str) -> str | None:
    """Which of the simstep launch's functions ``name`` is, if any."""
    for k in sb.KERNELS:
        if re.search(rf"(^|\W){k}\s*[(<]", name):
            return k
    return None


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    launches, seconds = 0, 0.0
    for name, (count, t) in tr["ops"].items():
        k = _kernel(name)
        if k is not None:
            seconds += t
            if k == sb.KERNELS[0]:
                launches += count
    if not launches or seconds <= 0:
        return None
    least = launches * max(run["simstep_launch_bytes"] / sb.HBM_BYTES_PER_S,
                           run["simstep_launch_ops"] / sb.F32_OPS_PER_S)
    return 100.0 * least / seconds
