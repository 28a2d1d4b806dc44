"""Fixed-shape programs captured as CUDA graphs: the port's counterpart of
``jax.jit``.

The JAX package runs every serving and training entry as one compiled XLA
program: the train step, whose forward, loss, backward and optimizer update
"all trace into one XLA program" (``nsdp_tpu/training/steps.py:1-12``,
``@partial(jax.jit, donate_argnums=(0,))`` at ``:154``; the evaluation steps
``@jax.jit`` at ``:249-289``), every serving bucket, compiled ahead of the
first request (``nsdp_tpu/serving.py:133-189``; the edit session's two
halves ``jax.jit`` at ``:355-356``), and the fused predict
(``nsdp_tpu/models/fast_predict.py:217,235``).  PyTorch runs eagerly: the
host queues each kernel from Python.  :class:`Graphs` captures a function
at one input signature into a ``torch.cuda.CUDAGraph`` and replays it, so
the host queues one graph where it queued hundreds to thousands of
launches.  The kernels and the arithmetic stay the function's own; only who
launches them changes.  The JAX package has no module of this name because
``jax.jit`` does this job there.

A captured function (a :class:`Program`) takes tensors or None and returns
a tensor, None, or tuples and lists of them.  Its contract:

* Static buffers.  A program that captures copies each call's arguments
  into its static input buffers (on its device, made at the capture;
  arguments may lie on the host) and returns its static output tensors.
  **Those outputs are overwritten by the next call of any program of the
  same** :class:`Graphs`: read or copy what must outlive it before that
  call, or ask for a copy (``copy=True``).
* Signatures.  A new signature -- every argument's shape and dtype, and
  which are None -- makes a new program, as ``jit`` compiles at the first
  call with a new shape; a signature seen before is reused.
* On the card, the first ``eager_calls`` calls at a signature run the
  function eagerly on a side stream (torch's warm-up rule), on its
  arguments moved to the device, and return its own results: each is a
  real call, such as a train step, which copies nothing and holds no
  static buffer, so a signature seen only that often costs what an eager
  call costs.  The next call captures the function with
  ``torch.cuda.graph`` on that side stream (capture records and does not
  run) and replays it once.  With ``eager_calls=0`` the first call makes
  one throw-away eager run on the side stream (for a function without
  side effects), then captures and replays.  The eager runs build the
  kernels (``ops/_build.py`` compiles at first use) and make their
  ``cudaFuncSetAttribute`` opt-ins before any capture.  A capture that
  fails raises; nothing carries on eagerly.  Replays go on the caller's
  current stream.
* On the CPU, which only the tests use, a program keeps the static-buffer
  contract at every call (its arguments copied into its inputs, its
  results copied into outputs it reuses) and runs the function directly,
  so the tests can show what a caller that keeps an output too long gets.

Collectives.  A function may run NCCL collectives (``torch.distributed``
on an NCCL group, ``parallel.capturable``): capture records each one as a
node of the graph without running it, and a replay runs it, so each rank
must capture at the same call and replay with the others -- a rank that
ran eagerly while another captured would wait in its collective for a
partner that never comes.  Programs decide by name, signature and call
count alone, so ranks that make the same calls at the same signatures (as
``training.steps.make_steps`` requires of a group) warm up, capture and
replay together, and no collective is ever replayed alone.  A capture
that fails on one rank raises there.  Gloo's collectives run on the host
and cannot be captured.  Captures keep ``torch.cuda.graph``'s default
``"global"`` error mode, in which a CUDA call unsafe during a capture
breaks it whatever thread makes it.  ProcessGroupNCCL's watchdog thread
queries the events of earlier eager collectives, yet captures begun while
such work was pending did not break on one NCCL rank (40 of 40 on an
H100, recorded in ``CHANGES.md`` with the grouped step's capture;
``tests/test_torch_card.py``'s ``capture_stress`` holds 20), so no
capture takes a laxer mode.

All programs of one :class:`Graphs` share one memory pool (``pool=`` of
``torch.cuda.graph``).  That is safe because they replay one at a time on
one stream, and every static output stays alive with its program, so no
later capture takes its memory.  What an earlier capture freed (its
intermediates) a later one may hold as an output, which is why an output
lives only until the next call of any program of the pool.  A replica of
the model keeps one :class:`Graphs` for all its programs.  A ``Graphs``
never drops a program's graph: the caching allocator refuses a capture
into a pool whose graphs were all destroyed while the pool still holds
memory (its ``use_count > 0`` internal assert, with or without
collectives: recorded in ``CHANGES.md`` with the one-pool change).
"""

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from nsdp_tpu_torch.utils.profiling import span

# Keep each captured graph's node list (``CUDAGraph(keep_graph=True)`` in
# debug mode), so that ``program.graph.debug_dump(path)`` can write it out:
# the exact list of the kernels every replay launches.  Off by default.
KEEP_GRAPHS = False


def _tree(fn, tree, *others):
    """``fn`` over the tensors of a (nested) tuple or list of tensors and
    None, and the tensors at the same places of ``others``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *others)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(fn, *parts) for parts in zip(tree, *others))
    raise TypeError(f"a captured function returns tensors, tuples, lists and None, not {type(tree)}")


def _signature(args: Sequence[Optional[torch.Tensor]]) -> Tuple:
    """Every argument's (shape, dtype), None where it is None."""
    for a in args:
        if a is not None and not isinstance(a, torch.Tensor):
            raise TypeError(f"a captured function takes tensors and None, not {type(a)}")
    return tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args)


class Program:
    """One function at one input signature: its static input buffers and
    its CUDA graph once captured, and its static outputs.  Its
    :class:`Graphs` calls it (and holds it: a program keeps no reference
    back, so dropping the ``Graphs`` frees its graphs and memory at
    once)."""

    def __init__(self, fn: Callable, eager_calls: int, name: str):
        self.fn, self.eager_calls, self.name = fn, eager_calls, name
        self.inputs: Optional[list] = None  # made at the capture (on the CPU, the first call)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.calls = 0

    def __call__(self, graphs: "Graphs", *args, copy: bool = False):
        self.calls += 1
        device = graphs.device
        if device.type == "cuda" and self.calls <= self.eager_calls:
            with span("graphs.eager", self.name):
                return graphs.eager(self.fn, [None if a is None else a.to(device, non_blocking=True)
                                              for a in args])
        with span("graphs.stage", self.name):
            if self.inputs is None:
                self.inputs = [None if a is None else
                               torch.empty(a.shape, dtype=a.dtype, device=device) for a in args]
            for buf, a in zip(self.inputs, args):
                if buf is not None:
                    buf.copy_(a, non_blocking=True)
        if device.type != "cuda":
            with span("graphs.eager", self.name):
                out = self.fn(*self.inputs)
                if self.outputs is None:
                    self.outputs = _tree(torch.empty_like, out)
                _tree(lambda buf, t: buf.copy_(t), self.outputs, out)
        else:
            if self.graph is None:
                if self.eager_calls == 0:
                    with span("graphs.eager", self.name):
                        graphs.eager(self.fn, self.inputs)  # the warm-up run, thrown away
                with span("graphs.capture", self.name):
                    self.graph, self.outputs = graphs.capture(self.fn, self.inputs)
            with span("graphs.replay", self.name):
                self.graph.replay()
        return _tree(torch.clone, self.outputs) if copy else self.outputs


class Graphs:
    """The captured programs of one replica on one device, by name and
    input signature, sharing one side stream and one memory pool (both
    made at the first eager run on the card).

    ``graphs(name, fn, *args, eager_calls=0, copy=False)`` runs
    ``fn(*args)`` through the program for ``name`` at ``args``' signature,
    made at the first such call (module docstring); ``copy`` returns a
    copy of the static outputs that the caller owns (an eager call's
    results are its own already).  ``programs`` maps ``(name, signature)``
    to each :class:`Program`.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.programs: Dict[Tuple, Program] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None

    def __call__(self, name: str, fn: Callable, *args, eager_calls: int = 0, copy: bool = False):
        key = (name, _signature(args))
        program = self.programs.get(key)
        if program is None:
            program = self.programs[key] = Program(fn, eager_calls, name)
        return program(self, *args, copy=copy)

    def summary(self) -> Dict[str, int]:
        """``captured``: programs holding a graph; ``eager``: signatures
        that have run only eagerly (a program with ``eager_calls`` left,
        and every program on the CPU); ``replays``: the captured programs'
        replays."""
        graphs = [p for p in self.programs.values() if p.graph is not None]
        return {"captured": len(graphs), "eager": len(self.programs) - len(graphs),
                "replays": sum(p.calls - p.eager_calls for p in graphs)}

    def describe(self) -> str:
        """:meth:`summary` in words, for the entry points' reports."""
        s = self.summary()
        return (f"{s['captured']} programs captured ({s['replays']} replays),"
                f" {s['eager']} signatures eager")

    def eager(self, fn: Callable, inputs):
        """``fn(*inputs)`` on the side stream, after the current stream's
        work; the current stream then waits for it.  Every use of the side
        stream starts by waiting for the current one, so memory the current
        stream still reads is never reused under it."""
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            current = torch.cuda.current_stream()
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = fn(*inputs)
            current.wait_stream(self._stream)
        return out

    def capture(self, fn: Callable, inputs):
        """-> (the graph of ``fn(*inputs)`` captured on the side stream into
        the pool, its static outputs).  ``torch.cuda.graph`` synchronises
        the device before it begins."""
        graph = torch.cuda.CUDAGraph(keep_graph=KEEP_GRAPHS)
        if KEEP_GRAPHS:
            graph.enable_debug_mode()
        with torch.cuda.device(self.device):
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                out = fn(*inputs)
        return graph, out
