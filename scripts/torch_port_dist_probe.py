#!/usr/bin/env python3
"""Which torch.distributed collectives two ranks that share one card can use.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_port_dist_probe.py

For each of all_reduce, all_gather, all_gather_into_tensor, broadcast,
reduce_scatter_tensor and batch_isend_irecv on gloo, and all_reduce on nccl,
two fresh processes join a group of two ranks, both on cuda:0, and call the
collective once on CUDA tensors. Each probe is reported as "ok" (its result
checked), "wrong result", the last error line a rank printed with its exit
code or signal (and NCCL's first warning: the children run with
NCCL_DEBUG=WARN), or "still running" at the deadline (then killed). The port's
collectives (gnn_tumor_seg_tpu_torch/parallel/collectives.py) stage every
collective of a gloo group on a card through pinned host buffers; this says
which of them would not need to, and whether NCCL serves two ranks on one
card.

Prints one JSON object, then the card's name and power limit as nvidia-smi
gives them. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time

DEADLINE_S = 60

_CHILD = r"""
import datetime, sys, torch, torch.distributed as dist
backend, op, rank, init = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group(backend, init_method=init, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=45))
dev = torch.device("cuda", 0)
full = lambda v, n=4: torch.full((n,), float(v), device=dev)
if op == "all_reduce":
    t = full(rank + 1); dist.all_reduce(t); good = bool((t == 3).all())
elif op == "all_gather":
    parts = [torch.empty(4, device=dev) for _ in range(2)]
    dist.all_gather(parts, full(rank))
    good = all(bool((p == i).all()) for i, p in enumerate(parts))
elif op == "all_gather_into_tensor":
    t = torch.empty(8, device=dev); dist.all_gather_into_tensor(t, full(rank))
    good = bool((t.view(2, 4)[1] == 1).all())
elif op == "broadcast":
    t = full(rank); dist.broadcast(t, src=1); good = bool((t == 1).all())
elif op == "reduce_scatter_tensor":
    t = torch.empty(4, device=dev); dist.reduce_scatter_tensor(t, full(1, 8))
    good = bool((t == 2).all())
else:
    recv = torch.empty(4, device=dev)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, full(rank), 1 - rank),
                                       dist.P2POp(dist.irecv, recv, 1 - rank)]):
        req.wait()
    good = bool((recv == 1 - rank).all())
torch.cuda.synchronize()
print("RESULT", "ok" if good else "wrong result", flush=True)
dist.destroy_process_group()
"""

PROBES = [("gloo", op) for op in ("all_reduce", "all_gather",
                                  "all_gather_into_tensor", "broadcast",
                                  "reduce_scatter_tensor", "batch_isend_irecv")]
PROBES.append(("nccl", "all_reduce"))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def probe(backend: str, op: str) -> str:
    init = f"tcp://localhost:{_free_port()}"
    # NCCL names the cause of an "invalid usage" only in its own warnings
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, backend, op, str(r),
                               init], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              start_new_session=True) for r in range(2)]
    end = time.monotonic() + DEADLINE_S
    outcomes = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
            outcomes.append(f"still running after {DEADLINE_S} s, killed")
            continue
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode == 0 and lines:
            outcomes.append(lines[-1][len("RESULT "):])
        else:
            code = (f"signal {-p.returncode}" if p.returncode < 0
                    else f"exit {p.returncode}")
            msg = [ln.strip() for ln in err.splitlines() if ln.strip()]
            # the error itself, not the warnings printed at exit after it
            errs = [ln for ln in msg if "Error" in ln or "what():" in ln]
            nccl = [ln.strip() for ln in (out + err).splitlines()
                    if "NCCL WARN" in ln]     # NCCL_DEBUG prints to stdout
            outcomes.append(f"{code}: {(errs or msg or [''])[-1][:300]}"
                            + (f" [{nccl[0][:200]}]" if nccl else ""))
    return outcomes[0] if outcomes[0] == outcomes[1] else " / ".join(outcomes)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    result = {f"{backend} {op}": probe(backend, op) for backend, op in PROBES}
    result.update(torch=torch.__version__, cuda=torch.version.cuda,
                  setup="two ranks, both on cuda:0, CUDA tensors")
    print(json.dumps(result))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
