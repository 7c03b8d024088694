"""Reduction of a ``torch.profiler`` trace of the measured window to the
numbers the per-layer readers take: device time by the bench span that
launched it, by kernel name, the program's own kernels apart, summed over
the cards, and each card's busy time as the union of its operations'
intervals, averaged over the cards the cell uses.

Each device operation is put in the span open on the host when it was
launched: its launch is the CUDA runtime call with the same correlation
id, or else the host operation it is linked to.  The backward of a force
evaluation runs on autograd's device thread, so a span's tree of host
operations misses it; the launch time does not.

The program's own kernels are told from PyTorch's and the CUDA libraries'
(cuBLAS, cuSOLVER, CUB) by name (:func:`is_library`): a kernel that a
later change adds or renames counts as the program's unless its name
carries one of the libraries' marks.  The profiler also projects each
``record_function`` span onto the device's timeline; those are no
operations and are left out.
"""

from __future__ import annotations

import bisect
from collections import Counter
from types import SimpleNamespace

# marks of kernels that PyTorch, cuBLAS / cuBLASLt, CUTLASS, CUB and the
# driver launch: namespaces, library prefixes, the copy engines' names, and
# PyTorch kernels whose names lose their namespace (index_put's backward)
LIBRARY_MARKS = ("at::", "at_cuda_detail", "c10::", "cub::", "thrust::", "cublas", "cutlass",
                 "cudnn", "cusolver", "magma", "gemm", "gemv", "xmma", "nvjet", "splitk",
                 "getrf", "getrs", "potrf", "trsm", "trsv", "ipiv", "pivot", "xxtrf",
                 "reduction_prod_kernel", "memcpy", "memset", "elementwise_kernel",
                 "reduce_kernel", "indexing_backward_kernel")
SPANS = ("bench.rebuild", "bench.force")
NAME_CHARS = 120  # kernel names are cut to this many characters in the breakdown


def is_library(name: str) -> bool:
    n = name.lower()
    return any(mark.lower() in n for mark in LIBRARY_MARKS)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(prof, n_devices: int = 1) -> SimpleNamespace:
    """Device seconds of the window's operations: ``busy_s`` (each card's
    union, averaged over ``n_devices`` cards), ``window_s``, ``by_span``
    {span: s} and ``own_by_span`` {span: s} (the program's kernels),
    ``own_s``, ``by_name`` Counter (these summed over the cards), ``idle``
    Counter of idle seconds by the host span open at the gap (averaged over
    the cards), and ``links`` (how many operations were placed by runtime
    call, by host operation, or not)."""
    from torch.autograd import DeviceType

    runtime, ops, spans, device = {}, {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.name().startswith("bench."):
            continue  # the spans' own projection onto the device's timeline
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                           e.correlation_id(), e.linked_correlation_id(), e.device_index()))
            continue
        name, t = e.name(), e.start_ns()
        if name.startswith("bench."):
            spans.append((t, t + e.duration_ns(), name))
        elif name.startswith("cu"):
            runtime.setdefault(e.correlation_id(), t)
        else:
            ops.setdefault(e.correlation_id(), t)
    windows = [s for s in spans if s[2] == "bench.window"]
    if not windows or not device:
        return None
    w0, w1 = windows[0][0], windows[0][1]
    inner = sorted(s for s in spans if s[2] in SPANS)
    starts = [s[0] for s in inner]
    episodes = sorted(s for s in spans if s[2] == "bench.episode")
    ep_starts = [s[0] for s in episodes]

    def span_at(t):
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= inner[k][1]:
            return inner[k][2]
        k = bisect.bisect_right(ep_starts, t) - 1
        if k >= 0 and t <= episodes[k][1]:
            return "bench.episode"
        return "bench.window"

    by_span, own_by_span, by_name = Counter(), Counter(), Counter()
    links = Counter()
    busy = {}
    own_s = 0.0
    for name, a, b, corr, linked, card in device:
        if b <= w0 or a >= w1:
            continue
        t = runtime.get(corr)
        if t is not None:
            links["runtime"] += 1
        else:
            t = ops.get(linked)
            links["op" if t is not None else "none"] += 1
        s = (b - a) * 1e-9
        span = span_at(t) if t is not None else "unplaced"
        by_span[span] += s
        by_name[name[:NAME_CHARS]] += s
        if not is_library(name):
            own_by_span[span] += s
            own_s += s
        busy.setdefault(card, []).append((max(a, w0), min(b, w1)))
    idle, busy_s = Counter(), 0.0
    for card in range(n_devices):  # a card with no operation idles all the window
        merged = _merge(busy.get(card, []))
        busy_s += sum(b - a for a, b in merged) * 1e-9 / n_devices
        edge = w0
        for a, b in merged + [[w1, w1]]:
            if a > edge:
                idle[span_at((a + edge) // 2)] += (a - edge) * 1e-9 / n_devices
            edge = max(edge, b)
    return SimpleNamespace(busy_s=busy_s, window_s=(w1 - w0) * 1e-9,
                           by_span=by_span, own_by_span=own_by_span, own_s=own_s, by_name=by_name,
                           idle=idle, links=links,
                           own_names=sorted({n[:NAME_CHARS] for n, *_ in device
                                             if not is_library(n)}),
                           cards=sorted(busy))
