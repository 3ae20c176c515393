#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors as they are.

    python3 tools/gloo_cuda_probe.py            # on the card

Two gloo ranks share ``cuda:0`` (as the parallel ViT's legs on one card
do) and run, each op and size in a world of its own, one collective on
CUDA tensors with no host copy: ``all_reduce``, ``all_gather``,
``all_to_all_single`` and a paired ``isend``/``irecv`` through
``batch_isend_irecv`` (the ring pass); ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` at the sizes the ZeRO step moves (the ViT's
71,946 and the CNN's 1,199,882 parameters, padded to two chunks); and a
one-way ``isend``/``irecv`` from rank 0 to rank 1 (the pipeline's
stage shift) of a ``[32, 16, 64]`` boundary activation in float32 and
bfloat16.  A rank checks what it got against
the values it should get.  Prints the card's name and power limit, the
torch version, then one JSON line per op: ``ok`` (both ranks right),
``wrong`` (ran, values differ), ``refused`` (an exception, its text kept)
or ``crashed`` (a rank died or hung: its exit code and the end of its
stderr).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import traceback

OPS = ("all_reduce", "all_gather", "all_to_all_single", "batch_isend_irecv",
       "reduce_scatter_tensor", "all_gather_into_tensor", "shift")
# f32 elements: a few, and one ring hop's k and v at the ViT's --sp 2 shard
# ([64, 8, 4, 16] each)
SIZES = (4, 2 * 64 * 8 * 4 * 16)
# (op, elements, dtype): the ZeRO step's flat buffers at N = 2 and the
# pipeline's boundary activation [32, 16, 64]
CASES = ([(op, n, "float32") for op in OPS[:4] for n in SIZES]
         + [(op, n, "float32") for op in OPS[4:6] for n in (4, 71946, 1199882)]
         + [("shift", 32 * 16 * 64, dt) for dt in ("float32", "bfloat16")])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(op: str, n: int, rank: int, port: int, dtype: str = "float32") -> None:
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    # rank r holds [0, n) + 10 r
    base = torch.arange(n, dtype=torch.float32).remainder(251).to(getattr(torch, dtype))
    x = base.to(dev) + 10 * rank
    try:
        if op == "all_reduce":
            dist.all_reduce(x)
            got, want = x, 2 * base + 10
        elif op == "all_gather":
            out = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(out, x)
            got, want = torch.cat(out), torch.cat([base, base + 10])
        elif op == "all_to_all_single":
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x)  # chunk j of x goes to rank j
            mine = base.chunk(2)[rank]
            want = torch.cat([mine, mine + 10])
        elif op == "reduce_scatter_tensor":
            got = torch.empty(n // 2, dtype=x.dtype, device=dev)
            dist.reduce_scatter_tensor(got, x)  # the sum's chunk `rank`
            want = (2 * base + 10).chunk(2)[rank]
        elif op == "all_gather_into_tensor":
            got = torch.empty(2 * n, dtype=x.dtype, device=dev)
            dist.all_gather_into_tensor(got, x)
            want = torch.cat([base, base + 10])
        elif op == "shift":  # rank 0's tensor to rank 1, nothing back
            got = x if rank == 0 else torch.empty_like(x)
            req = dist.isend(x, 1) if rank == 0 else dist.irecv(got, 0)
            req.wait()
            want = base
        else:
            got = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, got, 1 - rank)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            want = base + 10 * (1 - rank)
        torch.cuda.synchronize()
        res = {"ok": bool(torch.equal(got.cpu(), want)), "device": str(got.device),
               "max_err": float((got.cpu().float() - want.float()).abs().max())}
    except Exception as e:  # the probe's finding is the text
        res = {"ok": False, "error": f"{type(e).__name__}: {e}".splitlines()[0][:400],
               "where": traceback.format_exc().splitlines()[-1][:400]}
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()


def _probe(op: str, n: int, dtype: str) -> dict:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--op", op, "--n", str(n),
                               "--dtype", dtype, "--rank", str(r), "--port", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    ranks = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        last = out.strip().splitlines()[-1] if out.strip() else ""
        try:
            res = json.loads(last)
        except json.JSONDecodeError:
            res = {"ok": False}
        res.update(rc=p.returncode, stderr_tail=err.strip()[-600:] if p.returncode else "")
        ranks.append(res)
    if all(r["ok"] for r in ranks):
        verdict = "ok"
    elif any(r["rc"] not in (0, None) and "error" not in r for r in ranks):
        verdict = "crashed"
    elif any("error" in r for r in ranks):
        verdict = "refused"
    else:
        verdict = "wrong"
    return {"op": op, "n": n, "dtype": dtype, "verdict": verdict, "ranks": ranks}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", choices=OPS)
    ap.add_argument("--n", type=int)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--only", default=None,
                    help="comma-separated ops to probe (default: every op)")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port", type=int)
    a = ap.parse_args()
    if a.op:
        _rank(a.op, a.n, a.rank, a.port, a.dtype)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}))
    only = set(a.only.split(",")) if a.only else set(OPS)
    for op, n, dtype in CASES:
        if op in only:
            print(json.dumps(_probe(op, n, dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
