#!/usr/bin/env python3
"""What a CUDA graph capture tolerates: whether freeing a graph captured
before, while another capture runs, invalidates that capture, in
PyTorch's two capture modes ("global", the default, and "thread_local").

    python3 tools/graph_capture_probe.py

Each case runs in a fresh process (an invalidated capture can leave the
context unusable) and prints one line: the case, the mode, and "capture
OK" with the replayed value or "capture FAILED" with CUDA's message.
Cases: `control` (a collection inside the capture with nothing of CUDA to
free), `collect_here` (an earlier graph left in a reference cycle, then
`gc.collect()` inside the capture, on the capturing thread),
`reset_here` (`CUDAGraph.reset()` of the earlier graph inside the
capture) and `collect_other_thread` (the collection on another thread,
as a collection triggered in autograd's backward thread would be).
`train/loop.py::StepGraph` collects before each capture and keeps the
collector off during it because of what this shows. Needs a card."""
import gc
import subprocess
import sys
import threading

CASES = ("control", "collect_here", "reset_here", "collect_other_thread")


def case(name: str) -> str:
    import torch

    x = torch.ones(1024, device="cuda")

    def captured():
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = x * 2 + 1
        return g, y

    class Holder:
        pass

    mode = "thread_local" if name.endswith("_tl") else "global"
    base = name.removesuffix("_tl")
    old = None
    if base != "control":
        h = Holder()
        h.graph, h.out = captured()
        h.me = h                          # a cycle: only the collector frees it
        old = h
        del h
    torch.cuda.synchronize()
    gc.disable()
    g2 = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g2, capture_error_mode=mode):
            z = x + 3
            if base in ("control", "collect_here"):
                old = None
                gc.collect()
            elif base == "reset_here":
                old.graph.reset()
            elif base == "collect_other_thread":
                old = None
                t = threading.Thread(target=gc.collect)
                t.start()
                t.join()
            z = z * 5
        g2.replay()
        torch.cuda.synchronize()
        return f"{name} {mode} capture OK {float(z[0])}"
    except Exception as e:               # noqa: BLE001
        return f"{name} {mode} capture FAILED: {str(e).splitlines()[0]}"


def main() -> int:
    if len(sys.argv) > 1:
        print(case(sys.argv[1]), flush=True)
        return 0
    for c in CASES + tuple(c + "_tl" for c in CASES):
        out = subprocess.run([sys.executable, __file__, c],
                             capture_output=True, text=True, timeout=120)
        print(out.stdout.strip() or out.stderr.strip().splitlines()[-1],
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
