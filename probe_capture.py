"""Probe: CUDA-graph captures beside ProcessGroupNCCL's watchdog, and the
caching allocator's rule for graphs that share one memory pool.

    python3 probe_capture.py          # every case, each in a process of its own
    python3 probe_capture.py CASE     # one case, in this process

Needs one card.  Cases (each prints one ``case:`` line; the script exits
with 1 if a case does not end as stated here):

* ``pool-kept``: two captures into one pool (``torch.cuda.graph(pool=)``,
  as ``nsdp_tpu_torch/graphs.py`` shares one pool among a ``Graphs``'
  programs), the first graph kept alive: both capture and replay.
* ``pool-dropped``: the same, but the first graph is dropped while its
  output tensor lives: the pool keeps memory with no graph using it, and
  the second capture raises the allocator's internal assert
  (``use_count > 0``, ``CUDACachingAllocator.cpp``).  No collective runs.
* ``nccl-kept``: one NCCL rank; 40 captures of a program of 600 small
  kernels and 12 all-reduces, each capture begun right after 50 eager
  all-reduces that nothing waits for (ProcessGroupNCCL's watchdog thread
  then holds their work and queries their events), landing at several
  phases of the watchdog's loop, in ``torch.cuda.graph``'s default
  ``"global"`` capture mode; every graph kept, as a ``Graphs`` keeps its
  programs.  All capture, and every replay equals the eager run.
* ``nccl-dropped``: ``nccl-kept`` with each graph dropped after its replay
  while its output lives: fails at the second capture with the assert of
  ``pool-dropped``, the allocator's rule and not the watchdog.

Then it reports whether this PyTorch's ``libtorch_cuda`` holds the message
of ``CUDAGraph::capture_begin``'s wait for the NCCL watchdog's pending
event queries, and every warning the cases raised.
"""

import collections
import json
import mmap
import os
import socket
import subprocess
import sys
import time
import warnings

CASES = {"pool-kept": True, "pool-dropped": False, "nccl-kept": True, "nccl-dropped": False}
WAIT_MESSAGE = b"Waiting for pending NCCL work to finish before starting graph capture"


def program(torch, x, group=None):
    y = x
    for i in range(600):
        y = torch.tanh(y * 1.0001)
        if group is not None and i % 50 == 0:
            v = y.sum(0)
            torch.distributed.all_reduce(v, group=group)
            y = y + v * 1e-6
    return y


def case(name: str) -> dict:
    import torch

    torch.cuda.set_device(0)
    group = None
    if name.startswith("nccl"):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                             world_size=1, rank=0)
        group = torch.distributed.group.WORLD
    keep = not name.endswith("dropped")
    n = 2 if name.startswith("pool") else 40
    x = torch.randn(256, 256, device="cuda")
    side, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()
    kept, outputs, capture_ms, error = [], [], [], None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(n):
            if group is not None:
                for _ in range(50):  # eager collectives, not waited for
                    torch.distributed.all_reduce(torch.ones(1000, device="cuda"), group=group)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # the warm-up run
                want = program(torch, x, group)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    out = program(torch, x, group)
            except RuntimeError as e:
                error = f"capture {i}: {str(e).splitlines()[0][:200]}"
                break
            capture_ms.append((time.perf_counter() - t0) * 1e3)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                error = f"replay {i} differs from the eager run"
                break
            outputs.append(out)  # the output lives on
            if keep:
                kept.append(graph)
            del graph
            if group is not None:
                time.sleep(0.05 * (i % 4))
    if group is not None and error is None:
        torch.distributed.destroy_process_group()
    return {"case": name, "captures": len(capture_ms), "of": n, "error": error,
            "capture_ms": sorted(capture_ms)[len(capture_ms) // 2] if capture_ms else None,
            "capture_ms_max": max(capture_ms) if capture_ms else None,
            "warnings": sorted({str(w.message).splitlines()[0][:200] for w in caught})}


def library_waits() -> str:
    import torch

    path = os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cuda.so")
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        found = m.find(WAIT_MESSAGE) >= 0
    return f"{os.path.basename(path)} {'holds' if found else 'lacks'} {WAIT_MESSAGE.decode()!r}"


def main() -> None:
    if len(sys.argv) > 1:
        print("result: " + json.dumps(case(sys.argv[1])), flush=True)
        return
    import torch

    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.nccl.version(), torch.cuda.get_device_name(0), flush=True)
    print(library_waits(), flush=True)
    bad, seen = 0, collections.Counter()
    for name, ends_well in CASES.items():
        try:
            proc = subprocess.run([sys.executable, __file__, name], capture_output=True, text=True,
                                  timeout=300)
        except subprocess.TimeoutExpired:
            print(f"case: {name}: timed out", flush=True)
            bad += 1
            continue
        lines = [l for l in proc.stdout.splitlines() if l.startswith("result: ")]
        if not lines:
            tail = (proc.stderr.strip().splitlines() or ["(no output)"])[-1][:300]
            print(f"case: {name}: rc {proc.returncode}, no result: {tail}", flush=True)
            bad += 1
            continue
        r = json.loads(lines[-1][len("result: "):])
        seen.update(r.pop("warnings"))
        ok = (r["error"] is None) == ends_well
        if not ends_well:
            ok = ok and "use_count" in r["error"] and r["captures"] == 1
        bad += not ok
        print(f"case: {name}: {'as stated' if ok else 'NOT as stated'}: {json.dumps(r)}",
              flush=True)
    for message, count in seen.items():
        print(f"warning ({count} case(s)): {message}", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
