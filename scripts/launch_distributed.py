"""Multi-process launcher for the distributed training path.

Two modes (SURVEY.md §2.3 "Communication backend" — build-scope; the
reference is single-process NumPy and has no counterpart):

1. **Local gang** (one host with several GPUs, or virtual CPU devices
   for testing): spawn N ranks of any skge_tpu script on this machine,
   wiring `SKGE_COORDINATOR` / `SKGE_NUM_PROCESSES` / `SKGE_PROCESS_ID`
   so the script's `distributed.initialize()` call joins them into one
   JAX gang (NCCL on GPUs, Gloo on CPU). On GPUs rank r sees card r only
   (`CUDA_VISIBLE_DEVICES`): a JAX process reserves most of a card's
   memory, so two ranks cannot share one, and `--nproc` may not exceed
   the card count:

       python scripts/launch_distributed.py --nproc 4 -- python my_train.py
       python scripts/launch_distributed.py --nproc 2 \
           --devices-per-proc 2 -- python my_train.py   # CPU, 2 devices each

2. **Several hosts**: run the SAME training script once per host with the
   env vars pointing at host 0; this launcher just documents the
   contract, it does not ssh.

The child script only needs:

    from skge_tpu.parallel import distributed
    distributed.initialize()            # before any other jax call
    mesh = make_shard_mesh()            # spans the GLOBAL device list
    ...PartitionedTrainer(model, opt, triples, mesh)...
"""

import argparse
import os
import socket
import subprocess
import sys


def visible_gpus() -> list:
    """GPU ids this launcher may hand out: the parent's
    CUDA_VISIBLE_DEVICES if set, else every card `nvidia-smi -L` lists."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [g for g in env.split(",") if g.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [str(i) for i, ln in enumerate(out.splitlines()) if ln.strip()]


def rank_env(base: dict, rank: int, nproc: int, port: int,
             devices_per_proc: int, gpus: list) -> dict:
    """Environment of rank `rank`: the SKGE_* gang variables, plus either
    `devices_per_proc` virtual CPU devices or the single card gpus[rank]."""
    env = dict(base)
    env["SKGE_COORDINATOR"] = f"localhost:{port}"
    env["SKGE_NUM_PROCESSES"] = str(nproc)
    env["SKGE_PROCESS_ID"] = str(rank)
    if devices_per_proc:
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={devices_per_proc}"
        )
    else:
        env["CUDA_VISIBLE_DEVICES"] = gpus[rank]
    return env


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Spawn a local N-process JAX gang around a command."
    )
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument(
        "--devices-per-proc", type=int, default=0,
        help="give each rank this many virtual CPU devices (0 = one GPU "
        "per rank)",
    )
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to run per rank")
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (append: -- python train.py ...)")
    gpus = [] if args.devices_per_proc else visible_gpus()
    if not args.devices_per_proc and args.nproc > len(gpus):
        ap.error(f"--nproc {args.nproc} exceeds the {len(gpus)} visible "
                 "GPUs (one rank per card); use --devices-per-proc for CPU")

    port = args.port
    if port == 0:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]

    procs = [
        subprocess.Popen(cmd, env=rank_env(os.environ, rank, args.nproc, port,
                                           args.devices_per_proc, gpus))
        for rank in range(args.nproc)
    ]
    rcs = [p.wait() for p in procs]
    sys.exit(max(rcs) if rcs else 0)


if __name__ == "__main__":
    main()
