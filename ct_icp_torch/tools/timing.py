"""How the port's measurement scripts time a call on the card and bound it
(``chip_smoke.py``, ``tools/exp_gather.py``, ``tools/exp_lm_loop.py``).

A bound is the least time the card could take for a function: the larger
of the bytes it must move over the HBM rate and its float32 operations over
the float32 rate. Times are CUDA-event spans on the current stream; the
timers need a card, and nothing here touches it at import.
"""

import torch

# One H100 SXM (NVIDIA data sheet, full 700 W power limit): HBM rate and
# the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the float32 operations over the card's float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_of(fn, calls):
    """A CUDA graph of ``calls`` calls of ``fn`` (warmed up on a side
    stream first), or None where ``fn`` cannot be captured (a host read)."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        torch.cuda.synchronize()
        return g
    except RuntimeError as err:
        torch.cuda.synchronize()
        print(f"  (no graph capture: {str(err).splitlines()[0][:100]})",
              flush=True)
        return None


def time_stateless(fn, reps=50, graph_calls=20):
    """Mean ms of one ``fn()`` call on the card. Tries a CUDA graph of
    ``graph_calls`` calls (device time, no host launch overhead); where the
    call cannot be captured, back-to-back calls between two events (the
    calls run again there, so a failing launch still raises). Returns (ms,
    method)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    g = graph_of(fn, graph_calls)
    if g is not None:
        replays = max(reps // graph_calls, 2)
        start.record()
        for _ in range(replays):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (replays * graph_calls), "cuda-graph"
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "events"


_L2_FLUSH = []


def time_cold(fn, reps=20):
    """Mean ms of one ``fn()`` on the card with the 50 MB L2 cache flushed
    before it (a 256 MB buffer written, which also keeps the device busy
    while the host enqueues the call), so rows come from HBM as a cold
    caller (a rebase) finds them: the call replayed from a CUDA graph of one
    call (one launch, no host gaps) where it can be captured, else called,
    between two events. Returns (ms, method)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.int32,
                                     device="cuda"))
    flush = _L2_FLUSH[0]
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    g = graph_of(fn, 1)
    run, how = ((fn, "events, L2 flushed") if g is None
                else (g.replay, "cuda-graph, L2 flushed"))
    total = 0.0
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, how


def time_graph(reset, fn, reps=20):
    """Mean ms of ``fn()`` captured once in a CUDA graph and replayed
    between two events, ``reset()`` (which restores the state ``fn``
    updates) run before each replay outside them. The span holds the
    graph's submission as well as the call's device time: for a call of a
    few microseconds, most of it (:func:`time_kernels` is the kernels'
    own time). Returns (ms, method)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        reset()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    total = 0.0
    for _ in range(reps):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, "cuda-graph"


def time_host(fn, reps=50):
    """Mean ms of one ``fn()`` between an event recorded before the Python
    call and one recorded after it, the device idle before each: the
    host's enqueue (the wrapper's checks and allocations, the launch) and,
    where the device outlasts it, the device time. Returns (ms, method)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, "events around the call"


def time_kernels(fn, reset=None, reps=5):
    """Median device ms of one ``fn()`` call's device operations (their
    durations in torch.profiler's trace, summed), over ``reps`` traced
    calls, ``reset()`` (which restores the state ``fn`` updates) run before
    each outside the trace: the card's own time, without the launch's host
    side or a graph's submission. Returns (ms, method), ms None where the
    profiler saw no device operation."""
    from torch.profiler import ProfilerActivity, profile
    spans = []
    for _ in range(reps):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if us:
            spans.append(sum(us) / 1e3)
    if not spans:
        return None, "profiler (no device activity seen)"
    spans.sort()
    return spans[len(spans) // 2], "profiler kernel duration"
