"""Forward against decode on hymba-1.5b with the JAX package's own init.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/hymba_forward_decode.py \
        [--tokens 1088] [--layers 32] [--seed 0]

Settles whether the forward-against-decode gap of the served hymba-1.5b
(ROADMAP C8) is the JAX init's conditioning or the port's: on the CPU,
in float32, it draws the weights with ``repro``'s ``Model.init`` from
``jax.random.key(seed)`` at full width and runs

* JAX's forward (dense attention) against JAX's own decode
  (``decode_step``, float32 cache), token by token;
* the port's plain path (``repro_torch``, the same weights through
  ``convert.model_params_from_numpy``) forward against its decode;
* the port against JAX, forward and decode.

Each difference is max |a - b| over max |a| of the logits, with the
token where it peaks.  One process holds both models: ~13 GB of
float32 weights at 32 layers; ``--layers`` cuts the depth.  Like the
tests, this script imports both packages; the port itself imports
neither JAX nor ``repro``.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.models import decode as JD
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import decode as D

ARCH = "hymba-1.5b"


def rel(a: np.ndarray, b: np.ndarray) -> dict:
    """max |a - b| / max |a| over (1, S, V) logits, and its token."""
    diff = np.abs(a - b).max(axis=-1)[0]              # (S,)
    scale = float(np.abs(a).max())
    return {"rel": float(diff.max()) / scale, "token": int(diff.argmax()),
            "rel_median_token": float(np.median(diff)) / scale}


def main() -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=1088)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: the config's 32 layers)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_grad_enabled(False)

    change = {"n_layers": args.layers} if args.layers else {}
    jcfg = dataclasses.replace(jax_config(ARCH), **change)
    tcfg = dataclasses.replace(get_config(ARCH), **change)
    s = args.tokens
    tokens = np.random.default_rng(args.seed).integers(
        0, jcfg.vocab_size, (1, s)).astype(np.int32)
    out = {"arch": ARCH, "layers": jcfg.n_layers, "tokens": s,
           "seed": args.seed}

    t0 = time.perf_counter()
    jm = JaxModel(jcfg, remat="none", attn_impl="dense")
    params = jm.init(jax.random.key(args.seed))
    j_fwd = np.asarray(jm.forward(params, {"tokens": jnp.asarray(tokens)})[0])
    state = JD.init_state(jm, 1, s, cache_dtype="float32")
    step = jax.jit(lambda p, st, tok: JD.decode_step(jm, p, st, tok))
    j_dec = []
    for t in range(s):
        logits, state = step(params, state, jnp.asarray(tokens[:, t:t + 1]))
        j_dec.append(np.asarray(logits))
    j_dec = np.concatenate(j_dec, axis=1)
    del state
    out["jax_seconds"] = time.perf_counter() - t0
    out["jax_forward_vs_jax_decode"] = rel(j_fwd, j_dec)
    print(f"JAX forward vs JAX decode: {out['jax_forward_vs_jax_decode']}",
          flush=True)

    t0 = time.perf_counter()
    tree = jax.tree.map(np.asarray, params)
    del params
    tm = model_params_from_numpy(tree, tcfg, device="cpu")
    del tree
    tok = torch.from_numpy(tokens).long()
    t_fwd = tm(tok).numpy()
    st = D.init_state(tm, 1, s, cache_dtype="float32")
    t_dec = torch.cat([D.decode_step(tm, st, tok[:, t:t + 1])
                       for t in range(s)], dim=1).numpy()
    out["port_seconds"] = time.perf_counter() - t0
    out["port_forward_vs_port_decode"] = rel(t_fwd, t_dec)
    out["port_forward_vs_jax_forward"] = rel(j_fwd, t_fwd)
    out["port_decode_vs_jax_decode"] = rel(j_dec, t_dec)
    for k in ("port_forward_vs_port_decode", "port_forward_vs_jax_forward",
              "port_decode_vs_jax_decode"):
        print(f"{k}: {out[k]}", flush=True)
    out["peak_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
