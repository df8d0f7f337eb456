"""Can two ranks on ONE card initialise NCCL and exchange point to point?

    python examples/torch_nccl_probe.py

Spawns two processes that both take card 0, initialise an NCCL group of
two through a free localhost port, make one all-reduce and one
``batch_isend_irecv`` swap, and print one JSON line each (``ok``, or the
exception NCCL raised; ``NCCL_DEBUG=WARN`` puts NCCL's own messages on
standard error). A last line sums them up: ``{"two_ranks_one_card":
true|false}``. Each rank has 120 s; a rank still running then is killed
and counts as a failure. Exits 0 either way: the answer is the output.
"""
import datetime
import json
import multiprocessing as mp
import os
import socket
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
            rank=rank, timeout=datetime.timedelta(seconds=60),
            device_id=torch.device("cuda", 0))
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        recv = torch.zeros(4, device="cuda")
        ops = [dist.P2POp(dist.isend, x, 1 - rank),
               dist.P2POp(dist.irecv, recv, 1 - rank)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize()
        out.update(ok=True, all_reduce=x.tolist(), received=recv.tolist())
        dist.destroy_process_group()
    except Exception as exc:  # the answer is the exception: report it
        out.update(ok=False, error=f"{type(exc).__name__}: {exc}"[:4000])
    print(json.dumps(out), flush=True)
    sys.exit(0 if out["ok"] else 1)


def main() -> int:
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port)) for r in (0, 1)]
    for p in procs:
        p.start()
    codes = []
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
            print(json.dumps({"rank": procs.index(p), "ok": False,
                              "error": "killed after 120 s"}), flush=True)
        codes.append(p.exitcode)
    print(json.dumps({"two_ranks_one_card": all(c == 0 for c in codes),
                      "exit_codes": codes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
