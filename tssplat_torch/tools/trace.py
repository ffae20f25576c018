"""The top device operations of a profiler trace of the port (the
counterpart of ``examples/trace_top.py``).

    python -m tssplat_torch.tools.trace top DIR [n_steps] [top_k]

``top`` reads the newest ``*.json`` under DIR as ``export_chrome_trace``
wrote it (no tensorboard): the driver's ``profile_iters: [start, stop]``
writes ``<output_path>/trace/trace_<pid>.json`` (``utils/profiling.py
trace_profile``, CUDA activity included on the card), and any other
``export_chrome_trace`` file is read the same way. It prints the device
operations (kernel, memset and memcpy events) by time: ms and count a step
(the totals over ``n_steps``, default 1), the top ``top_k`` (default 30)
and their sum; then one JSON line, {"metric": "trace_device_ms_per_step",
"value": the device time of every operation a step, ...}.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import sys

# chrome-trace categories of the operations that run on the device
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def device_ops(trace_path: str):
    """({name: total us}, {name: count}) of the device operations in a
    chrome trace."""
    with open(trace_path) as fh:
        tr = json.load(fh)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    dur = collections.defaultdict(float)
    cnt = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() \
                in DEVICE_CATS:
            dur[e.get("name", "")] += float(e.get("dur", 0.0))
            cnt[e.get("name", "")] += 1
    return dict(dur), dict(cnt)


def top(trace_dir: str, n_steps: int = 1, top_k: int = 30) -> float:
    """Print the top device operations of the newest trace under
    ``trace_dir`` and the JSON line; returns the device ms a step. Raises
    SystemExit when there is no trace or it holds no device operation."""
    files = sorted(glob.glob(os.path.join(trace_dir, "*.json")),
                   key=os.path.getmtime)
    if not files:
        raise SystemExit(f"no trace under {trace_dir}")
    dur, cnt = device_ops(files[-1])
    if not dur:
        raise SystemExit(f"no device operation in {files[-1]}")
    total = sum(dur.values()) / 1e3 / n_steps
    shown = 0.0
    for name, d in sorted(dur.items(), key=lambda kv: -kv[1])[:top_k]:
        ms = d / 1e3 / n_steps
        shown += ms
        print(f"{ms:9.4f} ms/step  x{cnt[name] / n_steps:<7g} {name[:100]}")
    print(f"(top {top_k} sum: {shown:.4f} ms/step of {total:.4f})")
    print(json.dumps({"metric": "trace_device_ms_per_step",
                      "value": round(total, 4), "unit": "ms/step",
                      "vs_baseline": None,
                      "ops_per_step": sum(cnt.values()) / n_steps}),
          flush=True)
    return total


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[0] != "top":
        raise SystemExit("usage: python -m tssplat_torch.tools.trace "
                         "top DIR [n_steps] [top_k]")
    top(argv[1], int(argv[2]) if len(argv) > 2 else 1,
        int(argv[3]) if len(argv) > 3 else 30)


if __name__ == "__main__":
    main()
