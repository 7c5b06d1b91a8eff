"""How the port's measurement scripts time a call on the card and bound it
(``chip_smoke.py``, ``tools/exp_gather.py``, ``tools/exp_lm_loop.py``).

A bound is the least time the card could take for a function: the larger
of the bytes it must move over the HBM rate and its float32 operations over
the float32 rate. Times are CUDA-event spans on the current stream; the
timers need a card, and nothing here touches it at import.
"""

import queue
import time

import torch

# One H100 SXM (NVIDIA data sheet, full 700 W power limit): HBM rate and
# the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Idle host time inside a torch.profiler trace on each side of the traced
# call. Kineto keeps a device activity only where its CUPTI timestamps lie
# inside the trace's host-clock window, and on the card's machines those
# timestamps stand off the host clock by a few hundred us up to 2.7 ms,
# differently from trace to trace: a trace that holds a few ms around a
# call loses its kernels at random (tools/exp_profiler.py; PERF.md §6).
PROFILE_MARGIN_S = 0.02
# The tracing process of fresh_process_traces takes no job once this many
# seconds have passed since its first trace (on some of the card's
# machines a process's traces lose their kernels from about 10 s after its
# first one on, margins or not: tools/exp_profiler.py, PERF.md §6), and is
# ended where a call of its jobs takes longer than the timeout.
FRESH_PROCESS_AGE_S = 5.0
FRESH_PROCESS_TIMEOUT_S = 300.0


def device_trace(fn):
    """``fn()`` traced by torch.profiler (CPU and CUDA activities) with
    :data:`PROFILE_MARGIN_S` of idle host time before the call and after
    its synchronize; returns the profile."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return prof


def device_events(prof, name=""):
    """The device events of a trace whose names hold ``name``."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name in e.name]


def first_device_trace(fn, most, reset=None):
    """The device events of the first of up to ``most`` traced ``fn()``
    calls (:func:`device_trace`, ``reset()`` before each outside the trace)
    that saw the device, and the number of traces taken; (None, most)
    where none did. A trace that saw nothing holds no measurement: on some
    of the card's machines a process's traces hold no device activity from
    about 10 s after its first trace on (PERF.md §6)."""
    for traces in range(1, most + 1):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        events = device_events(device_trace(fn))
        if events:
            return events, traces
    return None, most


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


def time_graph(reset, fn, reps=20, calls=1):
    """Mean ms of one ``fn()`` in a CUDA graph of ``calls`` calls replayed
    between two events, ``reset()`` (which restores the state ``fn``
    updates) run before each replay outside them: the first call of a
    replay finds the restored state, the others the state it left. The
    span holds the graph's submission as well as the calls' device time:
    for one call of a few microseconds, most of it (:func:`time_kernels`
    is the kernels' own time). Returns (ms, method)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        reset()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
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
    return (total / (reps * calls),
            "cuda-graph" if calls == 1 else f"cuda-graph of {calls}")


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


def time_kernels(fn, reset=None, reps=5, most=50):
    """Median device ms of one ``fn()`` call's device operations (their
    durations in torch.profiler's trace, summed), over ``reps`` traced
    calls that saw a device operation, ``reset()`` (which restores the
    state ``fn`` updates) run before each outside the trace: the card's own
    time, without the launch's host side or a graph's submission. Up to
    ``most`` calls are traced in all (:func:`first_device_trace`); the
    method names how many saw the device. Returns (ms, method), ms None
    where none did."""
    spans, traces = [], 0
    while len(spans) < reps and traces < most:
        events, n = first_device_trace(fn, most - traces, reset)
        traces += n
        if events:
            spans.append(sum(e.time_range.elapsed_us() for e in events) / 1e3)
    if not spans:
        return None, f"profiler (no device activity in {traces} traces)"
    spans.sort()
    return spans[len(spans) // 2], (f"profiler kernel duration ({len(spans)} "
                                    f"of {traces} traces saw the device)")


def copy_into(dsts, srcs):
    """Copy each tensor of ``srcs`` into the tensor of ``dsts`` beside it."""
    for dst, src in zip(dsts, srcs):
        dst.copy_(src)


def _run_job(kind, fn, args, restore):
    reset = None if restore is None else (lambda: copy_into(*restore))

    def call():
        fn(*args)

    if reset is not None:
        reset()
    call()                                      # warm-up
    if kind == "ms":
        return time_kernels(call, reset)
    events, traces = first_device_trace(call, 10, reset)
    return [e.name for e in events] if events else None, traces


def _tracer_main(inbox, outbox):
    # the context now, so that a process started ahead has it when its
    # first jobs come (no trace yet: its age starts at the first one)
    torch.zeros(1, device="cuda")
    first = None
    while True:
        jobs = inbox.get()
        if jobs is None:
            break
        first = first or time.time()
        results = [_run_job(*job) for job in jobs]
        del jobs
        torch.cuda.synchronize()
        outbox.put((results, time.time() - first))


# the tracing processes, each [process, its inbox, its outbox]: the one the
# next call takes first, then those started ahead of it
_TRACERS = []


def _spawn_tracer():
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    inbox, outbox = ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=_tracer_main, args=(inbox, outbox),
                       daemon=True)
    proc.start()
    return [proc, inbox, outbox]


def _end(tracer):
    proc, inbox, _ = tracer
    if proc.is_alive():
        inbox.put(None)
        proc.join(timeout=30)
    if proc.is_alive():
        proc.kill()
        proc.join()


def fresh_process_traces(jobs, ahead=1):
    """Traces taken in a process whose first trace is recent: on some of
    the card's machines a process's traces hold no device activity from
    about 10 s after its first trace on (PERF.md §6). The process is
    spawned at the first call; once it has traced for
    :data:`FRESH_PROCESS_AGE_S` it is ended after the call, and ``ahead``
    processes are kept started for the calls to come, the next of them
    taking the next call (more than one where calls follow each other
    closely: each needs seconds to start). ``jobs`` is a list
    of (kind, fn, args, restore): ``fn`` a function a module defines,
    ``args`` a tuple whose tensors are this process's, shared with the
    tracing process (CUDA IPC, no copy) and updated in place by the calls,
    ``restore`` None or (dsts, srcs), tensors whose srcs are copied into
    the dsts before each traced ``fn(*args)`` call (outside the trace), so
    that a call that updates its arguments starts from the same state
    each time. Kind "ms" gives :func:`time_kernels`'s (ms, method), kind
    "ops" the device operations' names of the first of up to ten traces
    that saw the device (None where none did) and the traces taken.
    Returns the results in the order of ``jobs``; :func:`end_fresh_process`
    ends the processes."""
    if not _TRACERS:
        _TRACERS.append(_spawn_tracer())
    proc, inbox, outbox = _TRACERS[0]
    torch.cuda.synchronize()
    inbox.put(jobs)
    t0 = time.time()
    while True:
        try:
            results, traced_s = outbox.get(timeout=1.0)
            break
        except queue.Empty:
            if not proc.is_alive():
                _TRACERS.pop(0)
                raise RuntimeError("the tracing process exited with code "
                                   f"{proc.exitcode}") from None
            if time.time() - t0 > FRESH_PROCESS_TIMEOUT_S:
                end_fresh_process()
                raise RuntimeError("the tracing process took more than "
                                   f"{FRESH_PROCESS_TIMEOUT_S} s") from None
    torch.cuda.ipc_collect()
    if traced_s > FRESH_PROCESS_AGE_S:
        _end(_TRACERS.pop(0))
        torch.cuda.ipc_collect()
        while len(_TRACERS) < ahead:
            _TRACERS.append(_spawn_tracer())
    return results


def end_fresh_process():
    """End the tracing processes of :func:`fresh_process_traces`, if any."""
    if not _TRACERS:
        return
    while _TRACERS:
        _end(_TRACERS.pop())
    torch.cuda.ipc_collect()
