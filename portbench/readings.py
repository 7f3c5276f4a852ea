"""The readings the limits of ``correct`` are set from (see PERF.md).

    python3 portbench/readings.py --workload <cell> --seconds 20 \
        --seeds 11,12,13 --control-seeds 11,12,13

Runs the cell once per seed in one process, each run as the benchmark
runs it (a shorter window), and prints one JSON line per seed with
every number its check compares.  On the control seeds it also prints
the control's readings: the plain reference in TF32 in the program's
place and, for a training cell, the reference over half of each batch.
``--program-tf32`` runs the program itself with TF32 products, its own
path in the precision below the configurations' float32, judged as a
run is (the reference keeps TF32 off).
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]
# a card filled with tensors of many sizes (the training cell's weights,
# gradients, moments and logits) needs segments that grow, not a new
# one for every size: without them the allocator holds half the card
# reserved and free, in pieces too small for the next tensor
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import harness, serve, train
    from portbench.port import load_config
    from portbench.traffic import load_mix

    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--program-tf32", action="store_true",
                    help="run the program with TF32 products (its own "
                         "path in the precision below float32)")

    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    cfg, mix = load_config(cell["config"]), load_mix(cell["traffic"])
    runner = {"serve": serve, "train": train}[mix["kind"]]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    device = torch.device("cuda", 0)
    tf32 = bool(cfg["tf32"]) or args.program_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, checks = runner.run(cfg, mix, seed, args.seconds, False, device,
                                 t0, cell["name"], control=seed in control)
        print(json.dumps({"seed": seed, "program_tf32": args.program_tf32,
                          "seconds": time.perf_counter() - t0,
                          "setup_s": run.setup_s, "steps": run.steps,
                          "numbers": {k: v for k, (v, _) in checks.items()}}),
              flush=True)
        del run
        torch.cuda.empty_cache()
    print(harness.power_limit(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
