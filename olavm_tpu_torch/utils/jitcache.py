"""The device prover's compiled programs as CUDA graphs; counterpart of
olavm_tpu/utils/jitcache.py and of olavm_tpu/stark/oracle_device.py `_jit`,
the layer through which the JAX device prover runs each step as one
compiled program.

`cached_jit(key, fn)` gives the program of `key`: a function of device
tensors, returning a tensor or a tuple of tensors, whose launches are the
same for every call with the same key and input shapes. `key` must fully
determine what `fn` launches, as `olavm_tpu`'s key does (the site's tag,
shapes, static metadata): every value that changes between proves (a
Fiat-Shamir challenge, anything derived from one, a table's data) enters as
an input tensor, never as a host value that a capture would bake into a
kernel's arguments or a fill.

On a card, the first call of a program with given input shapes runs `fn`
eagerly (its warm-up: it loads the kernel libraries and fills the twiddle
tables before any capture, and its result is the call's result), then
captures `fn` once more into a CUDA graph, reading its inputs from static
buffers. Every later call copies its inputs into those buffers and replays
the graph. A capture that fails raises with the key; nothing falls back to
running the program eagerly on the card. On the CPU, or inside `enabled(False)`
(prove_with_traces_device's `programs=False`), a program is `fn` called
directly.

Memory. A graph reads its i-th input from a view of one buffer per (input
position, dtype, device), shared by every program, and writes its i-th
output into a view of another (the copy is the graph's last node); a
buffer grows, as a new buffer that later captures take, when an input or
output outgrows it. A replay fills its input views just before it runs and
copies its outputs out just after, and replays run one at a time on the
current stream, so the buffers hold about the largest table's trace, Z and
quotient coefficients once, not once per program, table or CTL view.
A buffer outgrown within one prove stays for the graphs that read it. One
outgrown by a later prove (a prove of larger tables in the same process)
is freed: the growth drops every graph that reads that buffer position and
that the prove has neither captured nor replayed, and each such program is
captured again, on the new buffer, at its next use (`begin_prove`, which
the device prover calls first). So the buffers of a process hold about
what its largest prove needs, not the sum over the sizes it proved.
Every graph allocates its working memory from one pool per device, and
nothing stays live in the pool between replays, so the pool holds about
the largest program's working set, not the sum over the programs. A replay
returns copies of its outputs, which the caller owns. `clear()` drops every
program, buffer and pool (between sizes, say).

Where a capture goes wrong, and where each case is handled:
- baked values: a host int that reaches a fill or a kernel argument inside
  `fn` is frozen into the graph; the device prover passes the challenges as
  banks (stark/prover_device.py quotient_bank, composition_bank, fri_fold;
  stark/ctl_device.py DevChallenge) and keys the values that stay host
  ints (the STARK's compress challenge: prover_device._stark_key);
- fresh tensors: each prove makes new trace, coefficient and Z tensors;
  a graph reads only its buffers, which every replay fills;
- host syncs: `.item()`, `bool(tensor)`, `torch.nonzero`, a pageable copy
  or a library's first load inside `fn` fails the capture (it raises); the
  warm-up loads the libraries and builds the module caches first, and the
  host reads of the prover (z_last, the divisibility check) stay outside;
- streams: the kernels launch on torch.cuda.current_stream, which the
  capture sets to its own; the nvcc-built libraries link cudart statically
  and their launches are captured (checked on the card);
- ranks: the sharded prover's collectives stay outside the programs, and
  every rank captures its own.

olavm_tpu's module exports traced programs to disk, so that later processes
skip the trace. This cache lives in memory only: a CUDA graph holds device
addresses and cannot outlive its process.
"""

from __future__ import annotations

import contextvars
import ctypes
import time
from contextlib import contextmanager

import torch

from .. import kernels

# key -> Program
_PROGRAMS: dict = {}
# ("in" or "out", position, dtype, device) -> the largest buffer so far
_BUFFERS: dict = {}
# device -> the graph memory pool that every program on it shares
_POOLS: dict = {}
_ENABLED = contextvars.ContextVar("olavm_tpu_torch_programs", default=True)
# the proves begun in this process (begin_prove); a graph records the one it
# was captured in
_PROVES = [0]


def begin_prove() -> None:
    """Start a prove: a buffer that one of its captures outgrows is freed
    with the graphs that read it and that this prove has not used."""
    _PROVES[0] += 1


@contextmanager
def enabled(flag: bool):
    """Run programs as CUDA graphs (True, the default) or call their
    functions eagerly (False) within the block."""
    token = _ENABLED.set(bool(flag))
    try:
        yield
    finally:
        _ENABLED.reset(token)


class _Graph:
    """One captured graph of a program: the buffer views of its inputs and
    outputs, and what its capture recorded."""

    def __init__(self, graph, slots, outputs, launches, nodes, seconds,
                 pool_bytes):
        self.graph = graph
        self.slots = slots
        self.outputs = outputs
        self.launches = launches
        self.nodes = nodes
        self.capture_seconds = seconds
        self.pool_bytes = pool_bytes
        self.prove = _PROVES[0]  # the last prove that used the graph

    def replay(self, inputs):
        self.prove = _PROVES[0]
        for slot, t in zip(self.slots, inputs):
            slot.copy_(t)
        self.graph.replay()
        kernels.add_replayed(self.launches)
        return tuple(t.clone() for t in self.outputs)

    def reads(self, kind: str, i: int, dtype, device) -> bool:
        """Whether this graph's i-th input ("in") or output ("out") view
        lies in a buffer of that dtype and device."""
        views = self.slots if kind == "in" else self.outputs
        return (i < len(views) and views[i].dtype == dtype
                and views[i].device == device)


class Program:
    """The program of one key: a graph per input signature on the card, the
    function itself elsewhere."""

    def __init__(self, key, fn):
        self.key = key
        self.fn = fn
        self.graphs: dict = {}
        # since the program was made: graphs captured and dropped, replays
        # and the launches they ran (in all and by kernel), capture seconds
        self.captures = self.dropped = self.replays = 0
        self.replayed_launches = 0
        self.replayed_kernels = dict.fromkeys(kernels.LAUNCHES, 0)
        self.capture_seconds = 0.0

    def __call__(self, *inputs: torch.Tensor):
        device = inputs[0].device
        if device.type != "cuda" or not _ENABLED.get():
            return self.fn(*inputs)
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"program {self.key!r} called inside a capture")
        sig = (device, tuple((tuple(t.shape), t.dtype) for t in inputs))
        entry = self.graphs.get(sig)
        if entry is None:
            out = self.fn(*inputs)  # the warm-up
            graph = self.graphs[sig] = self._capture(device, inputs, out)
            self.captures += 1
            self.capture_seconds += graph.capture_seconds
            return out
        outs = entry.replay(inputs)
        self.replays += 1
        self.replayed_launches += sum(entry.launches.values())
        for k, v in entry.launches.items():
            self.replayed_kernels[k] += v
        return outs if self._returns_tuple else outs[0]

    def _capture(self, device, inputs, warm_out) -> _Graph:
        self._returns_tuple = isinstance(warm_out, (tuple, list))
        warm = tuple(warm_out) if self._returns_tuple else (warm_out,)
        # no replay is in flight when a buffer's growth drops a graph
        torch.cuda.synchronize(device)
        slots = [_view("in", i, t) for i, t in enumerate(inputs)]
        outputs = [_view("out", i, t) for i, t in enumerate(warm)]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # torch.cuda.graph empties the cache itself: empty it first, so that
        # the growth of the reserved memory is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(device), kernels.recording() as launches:
                # thread_local: a sync or pageable copy in this thread fails
                # the capture, while the process group's watchdog thread
                # may go on querying its events
                with torch.cuda.graph(graph, pool=_pool(device),
                                      capture_error_mode="thread_local"):
                    out = self.fn(*slots)
                    out = tuple(out) if self._returns_tuple else (out,)
                    if [o.shape for o in out] != [o.shape for o in warm]:
                        raise RuntimeError("the capture's outputs differ in "
                                           "shape from the warm-up's")
                    for view, o in zip(outputs, out):
                        view.copy_(o)
                    del out
            nodes = _graph_nodes(graph)
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(
                f"capture of program {self.key!r} failed: {e}") from e
        return _Graph(graph, slots, outputs, launches, nodes,
                      time.perf_counter() - t0,
                      torch.cuda.memory_reserved(device) - reserved)


def _view(kind: str, i: int, t: torch.Tensor) -> torch.Tensor:
    """A contiguous view of t's shape at the start of the buffer of (kind,
    position i, t's dtype and device), which grows to hold it."""
    numel = t.numel()
    key = (kind, i, t.dtype, t.device)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < numel:
        if buf is not None:
            _drop_earlier_readers(*key)
        buf = _BUFFERS[key] = torch.empty(max(numel, 1), dtype=t.dtype,
                                          device=t.device)
    return buf[:numel].view(t.shape)


def _drop_earlier_readers(kind: str, i: int, dtype, device) -> None:
    """Drop every graph that reads a buffer of (kind, position i, dtype,
    device), which is being outgrown, and that the prove now running has
    not used: the buffers it reads are freed once no graph holds them, and
    its program captures again at its next use."""
    for prog in _PROGRAMS.values():
        for sig, g in list(prog.graphs.items()):
            if g.prove < _PROVES[0] and g.reads(kind, i, dtype, device):
                g.graph.reset()
                del prog.graphs[sig]
                prog.dropped += 1


def _pool(device):
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return _POOLS[device]


def _graph_nodes(graph) -> int:
    """The captured graph's node count (libcuda's cuGraphGetNodes)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t()
    rc = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                 None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {rc}")
    return n.value


def cached_jit(key, fn) -> Program:
    """The program of `key` (made from `fn` at the key's first use)."""
    if key not in _PROGRAMS:
        _PROGRAMS[key] = Program(key, fn)
    return _PROGRAMS[key]


def stats() -> dict:
    """Per key (its repr), since its program was made: captures, graphs
    dropped (begin_prove), replays, the kernel launches those replays ran
    (in all and by kernel), capture seconds; and of the graphs it holds now: graph nodes, outputs, the bytes
    their captures added to the shared pool, the kernel launches of one
    replay of each (summed over the key's input shapes), in all and by
    kernel."""
    out = {}
    for key, prog in _PROGRAMS.items():
        graphs = list(prog.graphs.values())
        out[repr(key)] = {
            "tag": key[0] if isinstance(key, tuple) else key,
            "captures": prog.captures,
            "dropped": prog.dropped,
            "replays": prog.replays,
            "capture_seconds": prog.capture_seconds,
            "nodes": sum(g.nodes for g in graphs),
            # each output's copy into its buffer is one node of the graph
            "outputs": sum(len(g.outputs) for g in graphs),
            "pool_bytes": sum(g.pool_bytes for g in graphs),
            "launches": sum(sum(g.launches.values()) for g in graphs),
            "kernels": {k: n for k in kernels.LAUNCHES
                        if (n := sum(g.launches.get(k, 0) for g in graphs))},
            "replayed_launches": prog.replayed_launches,
            "replayed_kernels": dict(prog.replayed_kernels),
        }
    return out


def buffer_bytes() -> int:
    """Device bytes held by the input and output buffers of the graphs
    (those outgrown included)."""
    held = {}
    for prog in _PROGRAMS.values():
        for g in prog.graphs.values():
            for t in (*g.slots, *g.outputs):
                st = t.untyped_storage()
                held[st.data_ptr()] = st.nbytes()
    return sum(held.values())


def pool_bytes() -> int:
    """Device bytes reserved by the graphs' shared pools (the allocations
    that only graph replays use)."""
    if not _POOLS:
        return 0
    pools = {tuple(p) for p in _POOLS.values()}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def clear() -> None:
    """Drop every program, graph, static buffer and pool, and return their
    device memory to the card."""
    for prog in _PROGRAMS.values():
        for g in prog.graphs.values():
            g.graph.reset()
    _PROGRAMS.clear()
    _BUFFERS.clear()
    _POOLS.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
