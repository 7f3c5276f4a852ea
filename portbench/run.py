"""Run one benchmark cell once (see ``portbench/README.md``).

    python3 portbench/run.py --workload hymba-1.5b.chat --seed 7 \
        --seconds 45 --trace 0

The program under test is ``repro_torch`` from ``src/`` of the checkout.
Every build and kernel cache is kept under ``build/`` of the checkout.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the package by its name, never this folder's modules as top-level ones
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]
# a card filled with tensors of many sizes (the training cell's weights,
# gradients, moments and logits) needs segments that grow, not a new
# one for every size: without them the allocator holds half the card
# reserved and free, in pieces too small for the next tensor
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[key] = os.path.join(ROOT, "build", sub)
# one process on the card with few threads: the serving path is paced by
# the host, and idle worker threads spinning on other cores add noise
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(t_start=T_START))
