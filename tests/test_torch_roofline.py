"""The port's roofline (``repro_torch.roofline``) against JAX's.

* ``roofline_terms`` and ``model_flops`` equal JAX's on the same inputs,
  with the H100's constants passed to JAX's.
* ``cost.step_cost`` on the meta device counts JAX's ``hlo_cost`` FLOPs
  of the compiled chain program (4 and 8 layers of 1024^3 matmuls, with
  and without remat); remat adds exactly one recomputed forward's bytes
  (eager torch saves tensors by reference, so nothing it saves is
  traffic).
* Gathers by index and in-place writes into part of a tensor count as
  ``hlo_cost`` counts a dynamic slice and a dynamic-update-slice (twice
  the moved values, not the whole source or destination), on a JAX and
  torch pair; a llama3.2-1b decode step's bytes match a count worked
  out by hand.
* ``kernels`` gives each bound of PERF.md's kernel table at its shape,
  within 1e-4 ms (the table prints 4 decimals).
* ``analyze_step`` counts a decode step's attention: the kernel's
  launches and bytes on meta tensors, one per layer, where no dispatch
  mode sees a kernel.
* ``parse_collectives`` gives JAX's keys and sums for the same
  collectives, and a sharded sweep's folds and exchanges count as
  worked out by hand on a 2 x 2 layout.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as checkpoint

from repro.roofline import roofline_terms as jax_roofline_terms
from repro.roofline.analysis import model_flops as jax_model_flops
from repro.roofline.hlo import parse_collectives as jax_parse_collectives
from repro.roofline.hlo_cost import hlo_cost
from repro_torch.core.traces import fleet_demand_traces
from repro_torch.lab import get_scenario
from repro_torch.lab.sweep import run_sweep, sweep_demand
from repro_torch.lab.tune import grid_gains
from repro_torch.configs import get_config
from repro_torch.models import Model, decode as D
from repro_torch.roofline import (HBM_BW, ICI_BW, PEAK_FLOPS, analyze_step,
                                  model_flops, parse_collectives,
                                  roofline_terms, step_cost)
from repro_torch.roofline import constants as C
from repro_torch.roofline import kernels as K

# One intra-op thread: the suite's workers share the cores, and torch's
# OpenMP threads, oversubscribed, spin-wait ~100x longer than the ops.
torch.set_num_threads(1)

UNIT = 2 * 1024 ** 3          # one 1024^3 matmul


def test_constants_are_the_h100_data_sheet():
    assert (HBM_BW, C.PEAK_F32, C.PEAK_TF32, C.PEAK_BF16, C.PEAK_F64) == (
        3.35e12, 67e12, 495e12, 989e12, 34e12)
    assert PEAK_FLOPS == C.PEAK_BF16 and C.CHIP["ici_bw"] == ICI_BW


@pytest.mark.parametrize("flops,nbytes,coll", [
    (989e12, 3.35e12 / 2, 450e9 / 4),        # compute-bound
    (1e9, 3.35e12, 0.0),                      # memory-bound
    (1e9, 1e6, 450e9 * 3),                    # collective-bound
    (0.0, 0.0, 0.0)])
def test_roofline_terms_are_jax_terms(flops, nbytes, coll):
    kw = dict(hlo_flops_per_chip=flops, hlo_bytes_per_chip=nbytes,
              collective_bytes_per_chip=coll)
    assert roofline_terms(**kw) == jax_roofline_terms(
        **kw, peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW, ici_bw=ICI_BW)
    assert roofline_terms(**kw, peak_flops=C.PEAK_F32) == \
        jax_roofline_terms(**kw, peak_flops=C.PEAK_F32, hbm_bw=HBM_BW,
                           ici_bw=ICI_BW)


@pytest.mark.parametrize("args", [(10, 0, 100, "train"),
                                  (10, 0, 100, "prefill"),
                                  (100, 25, 10, "train"),
                                  (1_498_482_688, 0, 8, "decode")])
def test_model_flops_are_jax_model_flops(args):
    assert model_flops(*args) == jax_model_flops(*args)


# ---- the chain program -------------------------------------------------------

def _jax_chain(nl, remat):
    def body(x, w):
        return jnp.tanh(jnp.dot(x, w)), None

    def f(x, ws):
        g = jax.checkpoint(body) if remat else body
        x, _ = jax.lax.scan(g, x, ws)
        return x.sum()
    x = jax.ShapeDtypeStruct((1024, 1024), jnp.float32)
    ws = jax.ShapeDtypeStruct((nl, 1024, 1024), jnp.float32)
    return hlo_cost(jax.jit(jax.value_and_grad(f, argnums=(0, 1))).lower(
        x, ws).compile().as_text())


def _torch_chain(nl, remat):
    def body(x, w):
        return torch.tanh(x @ w)

    def step(x, ws):
        h = x
        for w in ws.unbind(0):
            h = (checkpoint.checkpoint(body, h, w, use_reentrant=False)
                 if remat else body(h, w))
        torch.autograd.grad(h.sum(), (x, ws))

    x = torch.empty((1024, 1024), device="meta", requires_grad=True)
    ws = torch.empty((nl, 1024, 1024), device="meta", requires_grad=True)
    return step_cost(step, x, ws)


@pytest.mark.parametrize("nl,remat,units", [
    (4, False, 12), (4, True, 16), (8, False, 24), (8, True, 32)])
def test_step_cost_flops_are_hlo_cost_flops(nl, remat, units):
    """fwd (N) + bwd (2N) [+ remat recompute (N)] matmuls."""
    got = _torch_chain(nl, remat)
    assert got["flops"] == _jax_chain(nl, remat)["flops"] == units * UNIT
    assert got["collective_bytes"] == 0.0 and got["kernels"] == {}


def test_remat_adds_exactly_one_recomputed_forward():
    """Eager torch saves a tensor for the backward by reference, so remat
    saves no traffic and adds the recomputed forward: its counted bytes
    and FLOPs rise by exactly one forward's.  (XLA's scan writes its
    saved residuals into stacked buffers, so there remat lowers the
    bytes: tests/test_roofline.py::test_remat_reduces_bytes.)"""
    plain, remat = _torch_chain(8, False), _torch_chain(8, True)
    x = torch.empty((1024, 1024), device="meta")
    ws = torch.empty((8, 1024, 1024), device="meta")
    forward = step_cost(lambda: [torch.tanh(x @ w) for w in ws.unbind(0)])
    assert forward["bytes"] == 8 * 5 * 1024 * 1024 * 4    # mm 3, tanh 2
    assert remat["bytes"] - plain["bytes"] == forward["bytes"]
    assert remat["flops"] - plain["flops"] == forward["flops"] == 8 * UNIT
    assert plain["bytes_by_op"]["mm"] > 0


# ---- gathers and in-place writes ----------------------------------------------

V, DM, B, S = 4096, 256, 8, 512          # table (V, DM), cache (B, S, DM)
ROWS = B * DM * 4                        # the rows read: (B, DM) float32
UPDATE = B * 1 * DM * 4                  # one position written


@pytest.fixture(scope="module")
def jax_slice_and_update():
    """JAX's ``hlo_cost`` of a dynamic slice of B rows of the table and a
    dynamic-update-slice of one position into the cache (donated, so the
    update is in place as the port's is)."""
    def f(table, start, cache, pos, x):
        return (jax.lax.dynamic_slice(table, (start, 0), (B, DM)),
                jax.lax.dynamic_update_slice(cache, x, (0, pos, 0)))
    args = (jax.ShapeDtypeStruct((V, DM), jnp.float32),
            jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((B, S, DM), jnp.float32),
            jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((B, 1, DM), jnp.float32))
    return hlo_cost(jax.jit(f, donate_argnums=2).lower(*args).compile()
                    .as_text())["bytes"]


READS = {"index": lambda t, ids: t[ids],
         "index_select": lambda t, ids: t.index_select(0, ids),
         "embedding": lambda t, ids: F.embedding(ids, t)}
AT, AT_B = (torch.full((n,), 7, device="meta") for n in (1, B))
SLOTS = torch.arange(B, device="meta")
WRITES = {  # (write, bytes of its indices)
    "index_copy_": (lambda c, x: c.index_copy_(1, AT, x), 8),
    "index_put_": (lambda c, x: c.index_put_((SLOTS, AT_B), x[:, 0]),
                   2 * B * 8),
    "copy_": (lambda c, x: c[:, 7:8].copy_(x), 0)}


@pytest.mark.parametrize("write", sorted(WRITES))
@pytest.mark.parametrize("read", sorted(READS))
def test_gathers_and_in_place_writes_count_as_hlo_cost_slices(
        jax_slice_and_update, read, write):
    """Twice the rows read and twice the update written, with the
    indices: JAX's two scalar starts, the port's index tensors."""
    table = torch.empty((V, DM), device="meta")
    cache = torch.empty((B, S, DM), device="meta")
    x = torch.empty((B, 1, DM), device="meta")
    ids = torch.zeros((B,), dtype=torch.int64, device="meta")
    fn, write_index_bytes = WRITES[write]
    got = step_cost(lambda: (READS[read](table, ids), fn(cache, x)))
    assert jax_slice_and_update == 2 * ROWS + 2 * UPDATE + 2 * 4
    assert got["bytes"] == 2 * ROWS + B * 8 + 2 * UPDATE + write_index_bytes


def test_accumulating_writes_read_their_destination_and_broadcasts_once():
    dst = torch.empty((64, 32), device="meta")
    src = torch.empty((8, 32), device="meta")
    idx = torch.zeros((8,), dtype=torch.int64, device="meta")
    one = 8 * 32 * 4
    assert step_cost(lambda: dst.index_add_(0, idx, src))["bytes"] == \
        3 * one + 8 * 8
    assert step_cost(lambda: dst.index_put_((idx,), src, True))["bytes"] \
        == 3 * one + 8 * 8
    assert step_cost(lambda: dst.scatter_add_(
        0, idx[:, None].expand(8, 32), src))["bytes"] == 3 * one + 8 * 8
    assert step_cost(lambda: dst.zero_())["bytes"] == 64 * 32 * 4
    bias = torch.empty((32,), device="meta")
    assert step_cost(lambda: dst + bias.expand(64, 32))["bytes"] == \
        2 * 64 * 32 * 4 + 32 * 4


def test_decode_step_bytes_are_worked_out_by_hand():
    """llama3.2-1b, 8 slots over a 1024-position cache, on meta: every
    matmul reads its f32 weight and its input and writes its output once;
    the embedding reads 8 rows (its table is read once, by the tied
    readout); each K and V write moves twice its values; decode attention
    reads the kept keys.  The rest (norms, rope, residual adds, the
    MLP's gate: element-wise passes over 8 tokens' activations) is 1.1%
    of the step."""
    cfg = get_config("llama3.2-1b")
    b, s = 8, 1024
    model = Model(cfg, device="meta", init=False)
    state = D.init_state(model, b, s)
    tokens = torch.zeros((b, 1), dtype=torch.int64, device="meta")
    with torch.no_grad():
        got = step_cost(D.decode_step, model, state, tokens)
    d, hd, h, kv, ff = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                        cfg.n_kv_heads, cfg.d_ff)
    vocab = model.tokens.shape[0]
    mats = cfg.n_layers * [(d, h * hd), (d, kv * hd), (d, kv * hd),
                           (h * hd, d), (d, ff), (d, ff), (ff, d)] + \
        [(d, vocab)]
    by_hand = {
        "mm": sum(4 * (b * i + i * o + b * o) for i, o in mats),
        "index": 2 * b * d * 4 + b * 8,
        "index_put_": cfg.n_layers * 2 * (2 * b * kv * hd * 2 + 2 * b * 8)}
    attn = cfg.n_layers * K.decode([s] * b, s, h, kv, hd).bytes
    for op, want in by_hand.items():
        assert got["bytes_by_op"][op] == want, op
    assert got["kernels"]["decode_attention"]["bytes"] == attn
    rest = got["bytes"] - sum(by_hand.values()) - attn
    assert 0.005 * got["bytes"] < rest < 0.02 * got["bytes"]
    weights = 4 * sum(p.numel() for p in model.parameters())
    assert weights < got["bytes"] < 1.1 * weights


# ---- the kernels' bounds -----------------------------------------------------

# PERF.md's kernel table: (work, its bound in ms as the table prints it)
BOUNDS = {
    "B1 cache-off": (lambda: K.sweep(4096, 1000, 64, cache=False), 0.1291),
    "B1 cache-on": (lambda: K.sweep(4096, 1000, 64, cache=True), 0.3365),
    "B1 graph": (lambda: K.sweep(4096, 1800, 64, cache=True, n_stages=4),
                 0.7888),
    # a 1024-node shard of spark-dag's 12 stages, the bins and work
    # entries the timed launch touched
    "B1 interval": (lambda: K.sweep_interval(1024, 64, cache=True,
                                             n_stages=12, hist_updates=576,
                                             work_reads=0), 0.0035),
    "B2 bf16": (lambda: K.flash(2, 4096, 32, 8, 64, bf16=True), 0.1390),
    "B2 f32": (lambda: K.flash(2, 4096, 32, 8, 64), 0.8332),
    "B2 llama": (lambda: K.flash(2, 256, 32, 8, 64), 0.0033),
    "B2 hymba window": (lambda: K.flash(1, 1088, 25, 5, 64, window=1024),
                        0.0229),
    "B2 hymba": (lambda: K.flash(1, 1088, 25, 5, 64), 0.0230),
    "B2 gemma3 window": (lambda: K.flash(2, 1088, 4, 1, 256, window=512),
                         0.0212),
    "B2 gemma3": (lambda: K.flash(2, 1088, 4, 1, 256), 0.0294),
    "B2 gemma3 bf16": (lambda: K.flash(2, 4096, 4, 1, 256, bf16=True),
                       0.0695),
    "B2 qwen2-moe": (lambda: K.flash(2, 1088, 16, 16, 128), 0.0588),
    "B2 whisper encoder": (lambda: K.flash(2, 1536, 20, 20, 64,
                                           causal=False), 0.1464),
    "B2 whisper encoder 1": (lambda: K.flash(1, 1500, 20, 20, 64,
                                             causal=False), 0.0698),
    "B2 whisper cross": (lambda: K.flash(2, 288, 20, 20, 64, skv=1536,
                                         causal=False), 0.0275),
    "B2 vision cross": (lambda: K.flash(2, 2048, 32, 8, 128, skv=1600,
                                        causal=False), 0.6508),
    "B2 vision cross 300": (lambda: K.flash(2, 300, 32, 8, 128, skv=1600,
                                            causal=False), 0.0953),
    "B3 decode_32k": (lambda: K.decode([32768] * 128, 32768, 32, 8, 64,
                                       q_itemsize=2), 2.5645),
    "B4": (lambda: K.ssm_scan(2, 4096, 3200, 16), 1.5026),
}


@pytest.mark.parametrize("row", sorted(BOUNDS))
def test_kernel_bounds_are_the_perf_table_bounds(row):
    work, want = BOUNDS[row]
    assert abs(work().bound_ms - want) <= 1e-4


def test_graph_critical_path_grows_with_intervals_alone():
    """The AppGraph carry's intervals wait on each other: the serial
    term is intervals x the chain's dependent operations x one float32
    latency, whatever the lanes and nodes; the graph-free sweep has
    none."""
    base = K.sweep(16, 1800, 64, cache=True, n_stages=12)
    assert base.critical_path_ms == pytest.approx(
        1800 * K.GRAPH_CHAIN_OPS["cache-on"] * C.F32_DEP_LATENCY_S * 1e3)
    for nodes, lanes in ((4096, 64), (16, 1), (8, 4096)):
        other = K.sweep(nodes, 1800, lanes, cache=True, n_stages=12)
        assert other.critical_path_ms == base.critical_path_ms
        assert (other.ops > base.ops) == (nodes * lanes > 16 * 64)
    longer = K.sweep(16, 3600, 64, cache=True, n_stages=12)
    assert longer.critical_path_ms == pytest.approx(
        2 * base.critical_path_ms)
    off = K.sweep(8, 1200, 64, cache=False, n_stages=4)
    assert off.critical_path_ms == pytest.approx(
        1200 * K.GRAPH_CHAIN_OPS["cache-off"] * C.F32_DEP_LATENCY_S * 1e3)
    assert K.sweep(8, 1200, 64, cache=False).critical_path_ms == 0.0
    # the serial term stands beside the two roofline terms, not in them
    assert base.bound_ms == K.bound(base.bytes, base.ops, base.peak)[0]


def test_bound_names_its_binding_term():
    assert K.bound(3.35e12, 1.0, C.PEAK_F32) == (1e3, "bytes")
    assert K.bound(1.0, 67e12, C.PEAK_F32) == (1e3, "operations")
    assert K.decode([5, 0, 40], 32, 4, 2, 16).bound_by == "bytes"


def test_data_dependent_work_counts_what_the_data_needs():
    # decode: lengths past the cache count the cache; a window keeps its
    # last keys; flash: the causal and windowed kept pairs
    assert K.decode_kept_keys([0, 5, 40], 32) == 37
    assert K.decode_kept_keys([0, 5, 40], 32, window=8) == 13
    assert K.kept_pairs(4, 4, True, 0) == 10
    assert K.kept_pairs(4, 4, True, 2) == 7
    assert K.kept_pairs(3, 5, False, 0) == 15


def test_one_interval_entry_counts_what_one_launch_touches():
    """The one-interval graph entry moves its state in and out, but of
    the (L, 4096) histogram only the bins it adds to (read and written)
    and of the work matrix only what its promotions read; its operations
    are one interval of the graph instance."""
    from repro_torch.kernels.sweep import state_names
    n, lanes, stages = 1024, 64, 7
    planes = len(state_names(True, True, True))
    fixed = (2 * planes * lanes * n + n + 11 * lanes + 3 * n
             + 2 * (stages + 1) + 2 * lanes) * 4
    got = K.sweep_interval(n, lanes, cache=True, n_stages=stages,
                           hist_updates=300, work_reads=50)
    assert got.bytes == fixed + (2 * 300 + 50) * 4
    most = K.sweep_interval(n, lanes, cache=True, n_stages=stages)
    assert most.bytes == fixed + (2 * lanes * n + n) * 4
    assert got.ops == K.sweep(n, 1, lanes, cache=True, n_stages=stages).ops
    assert got.bytes < K.sweep(n, 1, lanes, cache=True,
                               n_stages=stages).bytes


# ---- a step ------------------------------------------------------------------

def test_analyze_step_counts_a_decode_steps_attention_on_meta():
    cfg = get_config("llama3.2-1b-smoke")
    model = Model(cfg, device="meta", init=False)
    state = D.init_state(model, 3, 40)
    tokens = torch.zeros((3, 1), dtype=torch.int64, device="meta")
    n = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        row = analyze_step(D.decode_step, model, state, tokens,
                           desc=dict(kind="decode", tokens=3, n_params=n))
    dec = row["kernels"]["decode_attention"]
    one = K.decode([40] * 3, 40, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                   q_itemsize=4, kv_itemsize=2)
    assert dec["calls"] == cfg.n_layers
    assert dec["bytes"] == cfg.n_layers * one.bytes
    assert dec["ops"] == cfg.n_layers * one.ops
    assert row["hlo_flops_per_chip"] > dec["ops"]
    assert row["model_flops_total"] == 2.0 * n * 3
    assert row["roofline"]["dominant"] in ("compute", "memory")
    assert row["model_flops_utilization_bound"] == pytest.approx(
        row["model_flops_per_chip"] / C.PEAK_F32 / row["step_time_bound_s"])


def test_meta_tensors_outside_a_count_still_raise():
    from repro_torch.kernels import decode_attention as kd
    meta = torch.empty((1, 1, 1), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kd.decode_attention(meta, meta[None], meta[None], meta[0])


def test_parse_collectives_gives_jaxs_keys_and_sums():
    """The same collectives as HLO lines (JAX) and as reported records
    (the port)."""
    ops = [("all-reduce", "s32", (8, 4096)), ("all-reduce", "f64", (5, 8)),
           ("all-gather", "f32", (16, 64)), ("all-reduce", "s32", (8,))]
    width = {"s32": 4, "f32": 4, "f64": 8}
    hlo = "\n".join(
        f"  %c{i} = {dt}[{','.join(map(str, sh))}] {kind}({dt}"
        f"[{','.join(map(str, sh))}] %x{i})"
        for i, (kind, dt, sh) in enumerate(ops))
    records = [(kind, width[dt] * int(torch.tensor(sh).prod()))
               for kind, dt, sh in ops]
    assert parse_collectives(records) == jax_parse_collectives(hlo)
    with pytest.raises(ValueError, match="unknown collective"):
        parse_collectives([("broadcast", 4)])


@pytest.mark.parametrize("graph", [False, True])
def test_sharded_sweep_collectives_are_worked_out_by_hand(graph):
    """A 2 x 2 layout (two gain shards of two node shards) on the CPU:
    per gain shard and lane chunk of L lanes, every node shard's (L,
    4096) int32 histogram, its (K, L) float64 node sums and its (L,)
    maxes fold once; AppGraph adds each shard's (L,) int32 lane min an
    interval and one more at the segment's end.  One device folds
    nothing."""
    gains = grid_gains(lam=(0.3, 0.6), r0=(0.9, 0.93))   # 2 lanes a shard
    lanes, shards, n_steps = 8, 2, 20                  # padded to 8 lanes
    if graph:
        spec = get_scenario("limplock").replace(n_intervals=n_steps)

        def run(**kw):
            return run_sweep(spec, gains, **kw)
        sums, maxes = 6, 2              # + the work done; no cache
    else:
        demand = fleet_demand_traces(16, n_steps, 0.1, seed=3)

        def run(**kw):
            return sweep_demand(demand, gains, node_memory=125 * 2**30,
                                **kw)
        sums, maxes = 5, 2
    per_chunk = shards * lanes * (4096 * 4 + sums * 8 + maxes * 4)
    if graph:
        per_chunk += (n_steps + 1) * shards * lanes * 4
    got = step_cost(run, devices=("cpu",) * 4, node_shards=2)
    assert got["collective_bytes"] == 2 * per_chunk
    assert got["per_kind_bytes"] == {"all-reduce": 2 * per_chunk}
    n_folds = 4 + (n_steps + 1 if graph else 0)
    assert got["collectives"]["n_ops"] == 2 * n_folds
    assert got["collectives"]["largest"][0] == ("all-reduce",
                                                shards * lanes * 4096 * 4)
    assert step_cost(run, device="cpu")["collective_bytes"] == 0.0
