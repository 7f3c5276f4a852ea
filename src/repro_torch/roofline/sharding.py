"""Per-chip work of a sharded step, counted once on meta tensors.

The port has no SPMD compiler, so a cell's per-chip FLOPs and bytes are
not read from a partitioned program (JAX's ``analyze_compiled``): the
global step runs once on ``meta`` tensors under :class:`ShardCount`, which
counts each op as :func:`.cost.step_cost` does and splits it among the
chips that share it, by the specs.

* Every input carries its spec under the multi-pod axes (``.roles``, set
  by ``launch/cells.py``), read as logical roles per dimension:
  ``("pod", "data")`` is the batch (:data:`BATCH`), ``"data"`` the FSDP
  axis (:data:`FSDP`), ``"model"`` tensor/expert parallelism
  (:data:`TP`).  One count serves every mesh: a role stands for the
  mesh's batch axes, its ``data`` axis or its ``model`` axis.
* Each op's output takes its inputs' roles dimension by dimension: views
  and reshapes carry them to the dims they become, broadcasting ops join
  them, reductions drop the dims they reduce, a matrix product keeps
  its operands' outer dims.  FSDP does not pass from a weight into an
  activation (a matrix product's or a gather's output): the weight is
  gathered, or (decode) its partial sums are.  A parameter's gradient
  takes its parameter's roles when autograd hands it over (a hook): the
  reduce-scatter.
* An op's work divides by the product of the mesh axes its operands'
  and outputs' roles name: batch-sharded work by the batch axes, work
  on a tensor split over ``model`` (heads, d_ff, experts, vocab) by the
  model axis too, a parameter's optimizer update by its whole spec.
  Work that the specs replicate over ``model`` (``sharding_report``'s
  ``attn_tp`` false) counts whole on each chip of that axis, and the
  decode cells' replicated activations on every chip.
* A hand-written kernel's call (flash, decode attention, the scan)
  divides by the roles of the operand its wrapper names as its layout.

On a 1 x 1 mesh every divisor is 1 and the count is
:func:`.cost.step_cost`'s.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import WORK_COUNTS, count_collective
from ..models.moe import _group_size, padded_experts
from ..models.params import shard_shape, split_factors
from .collectives import COLLECTIVE_OPS, parse_collectives
from .cost import _ALLOCS, _Count, _is_view, _op_bytes

BATCH, FSDP, TP = 1, 2, 4

_RESHAPES = {"view", "_unsafe_view", "reshape", "_reshape_alias",
             "flatten", "unflatten", "view_as"}
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}
_GATHERS = {"index", "embedding", "index_select", "gather", "take"}
# writes of one tensor's values into places of another: the written
# tensor takes the values' roles dim for dim (a dispatch buffer filled
# from the batch is split as the batch is)
_SCATTERS = {"index_copy", "index_put", "scatter", "index_add",
             "scatter_add", "scatter_reduce", "masked_scatter"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "var", "std", "var_mean", "std_mean", "logsumexp", "norm",
               "linalg_vector_norm", "argmax", "argmin", "any", "all",
               "count_nonzero"}


def spec_roles(spec, ndim: int) -> Tuple[int, ...]:
    """The roles of a tensor whose spec under the multi-pod axes is
    ``spec``."""
    out = []
    for i in range(ndim):
        part = spec[i] if i < len(spec) else None
        names = (part,) if isinstance(part, str) else tuple(part or ())
        bits = 0
        if "pod" in names:
            bits |= BATCH
        elif "data" in names:
            bits |= FSDP
        if "model" in names:
            bits |= TP
        out.append(bits)
    return tuple(out)


def role_axes(mesh) -> Dict[int, Tuple[str, ...]]:
    """Each role's mesh axes on ``mesh``."""
    names = tuple(mesh.axis_names)
    batch = tuple(a for a in ("pod", "data") if a in names)
    return {BATCH: batch, FSDP: ("data",) if "data" in names else (),
            TP: ("model",) if "model" in names else ()}


def divisor(roles: int, mesh) -> int:
    """How many chips share an op whose tensors carry ``roles``."""
    axes = role_axes(mesh)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    used = set()
    for bit, names in axes.items():
        if roles & bit:
            used.update(names)
    return math.prod(sizes[a] for a in used)


def _reshape_roles(src: Sequence[int], shape_in: Sequence[int],
                   shape_out: Sequence[int]) -> Tuple[int, ...]:
    """Carry roles through a row-major reshape: a split dim's roles go to
    every output dim its elements span (a microbatch split of the batch
    keeps the batch split in each microbatch), a merge keeps them."""
    out = [0] * len(shape_out)
    inner_out = [math.prod(shape_out[j + 1:]) for j in range(len(shape_out))]
    for k, bits in enumerate(src):
        if not bits or shape_in[k] == 1:
            continue
        lo, hi = math.prod(shape_in[k + 1:]), math.prod(shape_in[k:])
        for j, n in enumerate(shape_out):
            if n > 1 and inner_out[j] < hi and inner_out[j] * n > lo:
                out[j] |= bits
    return tuple(out)


def _aligned(tags: Iterable[Tuple[Tuple[int, ...], Sequence[int]]],
             shape: Sequence[int]) -> Tuple[int, ...]:
    """Broadcasting: each operand's roles right-aligned on ``shape``,
    joined where the operand's dim has the output's size."""
    out = [0] * len(shape)
    for roles, in_shape in tags:
        off = len(shape) - len(in_shape)
        for k, bits in enumerate(roles):
            j = k + off
            if bits and 0 <= j < len(shape) and in_shape[k] == shape[j]:
                out[j] |= bits
    return tuple(out)


def _strip_fsdp(roles: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(b & ~FSDP for b in roles)


class ShardCount(_Count):
    """:func:`.cost.step_cost`'s count with each op's work kept by the
    roles its tensors carry (:attr:`by_roles`: roles -> [FLOPs, bytes])."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.flops = flops
        self.tags = WeakIdKeyDictionary()
        self.by_roles: Dict[int, List[float]] = collections.defaultdict(
            lambda: [0.0, 0.0])

    def tag(self, t: torch.Tensor, roles: Sequence[int]) -> None:
        if any(roles):
            self.tags[t] = tuple(roles)

    def roles(self, t: torch.Tensor) -> Tuple[int, ...]:
        return self.tags.get(t) or (0,) * t.dim()

    def _out_roles(self, name: str, args, kwargs, t_out: torch.Tensor
                   ) -> Tuple[int, ...]:
        x = args[0] if args and isinstance(args[0], torch.Tensor) else None
        shape = tuple(t_out.shape)
        if name in ("cat", "stack"):
            # the parts' roles joined dim for dim; stack adds a dim
            parts = [t for t in args[0] if t.dim()]
            dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) \
                % len(shape)
            out = [0] * (len(shape) - (name == "stack"))
            for t in parts:
                for k, b in enumerate(self.roles(t)):
                    out[k] |= b
            if name == "stack":
                out.insert(dim, 0)
            return tuple(out)
        if x is not None and name in _RESHAPES:
            return _reshape_roles(self.roles(x), x.shape, shape)
        if x is not None and name in ("permute", "transpose", "t",
                                      "swapaxes"):
            src = self.roles(x)
            if name == "permute":
                return tuple(src[d % x.dim()] for d in args[1])
            if name == "t":
                return src[::-1]
            a, b = args[1] % x.dim(), args[2] % x.dim()
            out = list(src)
            out[a], out[b] = out[b], out[a]
            return tuple(out)
        if x is not None and (name in ("slice", "narrow", "slice_backward")
                              or name == "as_strided"
                              and len(shape) == x.dim()):
            return self.roles(x)
        if x is not None and name == "select_backward":  # grad, sizes, dim
            src = list(self.roles(x))
            src.insert(args[2] % len(shape), 0)
            return tuple(src)
        if x is not None and name == "select":
            src = list(self.roles(x))
            del src[args[1] % x.dim()]
            return tuple(src)
        if x is not None and name == "squeeze":
            dims = args[1] if len(args) > 1 else range(x.dim())
            dims = {d % x.dim() for d in ([dims] if isinstance(dims, int)
                                          else dims)}
            return tuple(b for i, b in enumerate(self.roles(x))
                         if not (i in dims and x.shape[i] == 1))
        if x is not None and name == "unsqueeze":
            src = list(self.roles(x))
            src.insert(args[1] % (x.dim() + 1), 0)
            return tuple(src)
        if x is not None and name == "unbind":
            src = list(self.roles(x))
            del src[(args[1] if len(args) > 1 else 0) % x.dim()]
            return tuple(src)
        if name in _PRODUCTS:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
                else (args[0], args[1])
            ra, rb = self.roles(a), self.roles(b)
            if a.dim() == 2:
                out = (ra[0], rb[1])
            else:
                out = (ra[0] | rb[0], ra[1], rb[2])
            if name in ("addmm", "baddbmm"):
                bias = _aligned([(self.roles(args[0]), args[0].shape)],
                                shape)
                out = tuple(p | q for p, q in zip(out, bias))
            return _strip_fsdp(out)
        if x is not None and name in ("index", "embedding"):
            # x[ids, ...] or embedding(x, ids) over leading dims: the
            # indices' dims, then the source's dims past the indexed ones
            idx = [args[1]] if name == "embedding" else list(args[1])
            if all(isinstance(i, torch.Tensor) for i in idx):
                lead = torch.broadcast_shapes(*(i.shape for i in idx))
                out = _aligned([(self.roles(i), i.shape) for i in idx],
                               lead) + self.roles(x)[len(idx):]
                if len(out) == len(shape):
                    return _strip_fsdp(out)
        if x is not None and name.rstrip("_") in _SCATTERS:
            out = list(self.roles(x))
            for t in _tensors((args[1:], kwargs)):
                for k, b in enumerate(self.roles(t)[::-1]):
                    if k < len(out):
                        out[-1 - k] |= b
            return tuple(out)
        if x is not None and name in _GATHERS:
            return _strip_fsdp(_aligned(
                [(self.roles(t), t.shape) for t in _tensors((args, kwargs))],
                shape))
        if x is not None and name in _REDUCTIONS and len(shape) < x.dim():
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            if isinstance(dims, int):
                dims = [dims]
            if not dims:
                return (0,) * len(shape)
            drop = {d % x.dim() for d in dims}
            return tuple(b for i, b in enumerate(self.roles(x))
                         if i not in drop)
        return _aligned([(self.roles(t), t.shape)
                         for t in _tensors((args, kwargs))], shape)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self.flops.get_total_flops()
        out = func(*args, **kwargs)
        flops = self.flops.get_total_flops() - before
        name = func.overloadpacket.__name__
        n = 0
        if name not in _ALLOCS and not _is_view(func):
            n = _op_bytes(name, args, kwargs, out)
            self.bytes += n
            self.bytes_by_op[name] += n
        roles = 0
        for t in _tensors((args, kwargs)):
            for b in self.roles(t):
                roles |= b
        for o in _tensors(out):
            try:
                tags = self._out_roles(name, args, kwargs, o)
            except (IndexError, TypeError):      # an op's unforeseen form
                tags = (0,) * o.dim()
            if args and o is args[0]:            # in place: it keeps its own
                tags = tuple(p | q for p, q in zip(self.roles(o), tags))
            self.tag(o, tags)
            for b in tags:
                roles |= b
        acc = self.by_roles[roles]
        acc[0] += flops
        acc[1] += n
        return out


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def input_leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor in a cell's inputs: dicts, tuples,
    named tuples and dataclasses (a ``DecodeState``), None skipped."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
        return
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return
    for k, v in items:
        yield from input_leaves(v, f"{path}.{k}" if path else k)


def argument_bytes(inputs, mesh) -> Dict[str, int]:
    """Each input leaf's bytes on one chip: its ``shard_shape`` under its
    ``.spec`` on ``mesh`` times its item size (what XLA's
    ``argument_size_in_bytes`` sums)."""
    return {path: math.prod(shard_shape(t.shape, t.spec, mesh))
            * t.element_size() for path, t in input_leaves(inputs)}


def sharded_cost(fn, *args, params: Optional[Dict[str, torch.Tensor]] = None,
                 **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under :class:`ShardCount`.

    Every input tensor that carries ``.roles`` is tagged first;
    ``params`` (the model's own parameters, which the step binds its
    inputs into, each carrying ``.roles``) are tagged too and get a hook
    that tags each gradient with its parameter's roles.  Returns :func:`.cost.step_cost`'s
    ``flops``, ``bytes`` and ``bytes_by_op`` (global), ``by_roles``
    ({roles: [FLOPs, bytes]}) and ``kernels``: each kernel call's (name,
    Work, roles of its layout operand).
    """
    flops = FlopCounterMode(display=False)
    count = ShardCount(flops)
    for _, t in input_leaves((args, kwargs)):
        if hasattr(t, "roles"):
            count.tag(t, spec_roles(t.roles, t.dim()))
    hooks = []
    for p in (params or {}).values():
        roles = spec_roles(p.roles, p.dim())
        count.tag(p, roles)
        p.requires_grad_(True)
        hooks.append(p.register_hook(
            lambda g, r=roles: (count.tag(g, r), g)[1]))
    WORK_COUNTS.append(count.kernels)
    try:
        with flops, count:
            fn(*args, **kwargs)
    finally:
        WORK_COUNTS.remove(count.kernels)
        for h in hooks:
            h.remove()
    kernels = []
    for name, work, data, layout in count.kernels:
        if name in COLLECTIVE_OPS:
            continue
        r = 0
        for b in count.roles(layout):
            r |= b
        kernels.append((name, work(*data), r))
    return {"flops": float(flops.get_total_flops()
                           + sum(w.ops for _, w, _ in kernels)),
            "bytes": float(count.bytes + sum(w.bytes for _, w, _ in kernels)),
            "by_roles": {k: list(v) for k, v in count.by_roles.items()},
            "bytes_by_op": dict(count.bytes_by_op),
            "kernels": kernels}


def per_chip(cost: dict, mesh) -> dict:
    """A :func:`sharded_cost` result split over ``mesh``: per-chip FLOPs
    and bytes, and each kernel's per-chip work."""
    flops = bytes_ = 0.0
    for roles, (f, b) in cost["by_roles"].items():
        d = divisor(roles, mesh)
        flops += f / d
        bytes_ += b / d
    kernels: Dict[str, dict] = {}
    for name, w, roles in cost["kernels"]:
        d = divisor(roles, mesh)
        k = kernels.setdefault(name, dict(calls=0, ops=0.0, bytes=0.0,
                                          bound_ms=0.0))
        k["calls"] += getattr(w, "calls", 1)
        k["ops"] += w.ops / d
        k["bytes"] += w.bytes / d
        k["bound_ms"] += w.bound_ms / d
        flops += w.ops / d
        bytes_ += w.bytes / d
    return {"flops": flops, "bytes": bytes_, "kernels": kernels}


def combine(costs: Sequence[Tuple[float, dict]]) -> dict:
    """The linear combination sum(w * cost) of :func:`sharded_cost`
    results (the microbatch extrapolation)."""
    out = {"flops": 0.0, "bytes": 0.0,
           "by_roles": collections.defaultdict(lambda: [0.0, 0.0]),
           "bytes_by_op": collections.Counter(), "kernels": []}
    for w, c in costs:
        out["flops"] += w * c["flops"]
        out["bytes"] += w * c["bytes"]
        for r, (f, b) in c["by_roles"].items():
            out["by_roles"][r][0] += w * f
            out["by_roles"][r][1] += w * b
        for op, b in c["bytes_by_op"].items():
            out["bytes_by_op"][op] += w * b
        out["kernels"] += [(n, _Scaled(k, w), r) for n, k, r in c["kernels"]]
    out["by_roles"] = dict(out["by_roles"])
    out["bytes_by_op"] = dict(out["bytes_by_op"])
    return out


class _Scaled:
    """A kernel call's Work weighted by ``w``."""

    def __init__(self, work, w: float):
        self.calls = getattr(work, "calls", 1) * w
        self.ops = work.ops * w
        self.bytes = work.bytes * w
        self.bound_ms = work.bound_ms * w


# ---------------------------------------------------------------------------
# The collectives of a cell, from the layouts the specs describe
# ---------------------------------------------------------------------------

# Each collective's per-chip operand bytes, as the artifact states them.
COLLECTIVE_FORMULAS = {
    "fsdp_all_gather": "each weight with an fsdp-split dim, once per use: "
                       "its shard's bytes; train: microbatches x (1 "
                       "forward + 1 again under remat 'full'/'dots'), "
                       "prefill: 1, decode: 0 (weight-stationary)",
    "grad_reduce_scatter": "train, each fsdp-split weight, per microbatch: "
                           "its gradient's bytes split by tp only (the "
                           "operand before the scatter over data)",
    "grad_all_reduce_data": "train, each weight not split over data, per "
                            "microbatch: its gradient's bytes on one chip",
    "grad_all_reduce_pod": "train on the multi-pod mesh, once per step: each "
                           "gradient's shard (1 byte an element with int8 "
                           "compression, else its own type)",
    "tp_all_reduce": "each row-parallel product over a model-split "
                     "contraction (attention wo, MLP wo, shared experts' "
                     "wo, Mamba out_proj): B_chip x S x d x the activation's "
                     "bytes; train: microbatches x (forward + backward + 1 "
                     "under remat 'full'/'dots'), prefill: 1; with "
                     "seq_parallel a reduce-scatter of that operand and an "
                     "all-gather of it over model instead",
    "decode_partial_sums": "decode (replicated one-token activations), each "
                           "product whose contraction dims the weight's spec "
                           "splits: its output rows x output features on one "
                           "chip x 4 bytes (float32 partials); and each "
                           "self-attention layer whose cache splits its "
                           "sequence: B_chip x H x (hd + 2) x 4 (the partial "
                           "softmax)",
}

_BIASES = ("bq", "bk", "bv", "b_if", "b_gates", "conv_b", "dt_bias",
           "d_skip", "out_norm", "gate_bias")
_ROW_PARALLEL = ("attn.wo", "cross.wo", "mlp.wo", "shared.wo",
                 "mamba.out_proj")


def _meta(n_bytes: float) -> torch.Tensor:
    return torch.empty((int(n_bytes),), dtype=torch.uint8, device="meta")


def _shard_elems(t: torch.Tensor, mesh) -> int:
    return math.prod(shard_shape(t.shape, t.spec, mesh))


def _contraction(name: str, t: torch.Tensor) -> Optional[Tuple[int, ...]]:
    """The dims of weight ``name`` that a product contracts, or None for a
    tensor no product contracts (norms, biases, the conv, the sLSTM
    recurrence, which is replicated)."""
    leaf = name.rsplit(".", 1)[-1]
    if t.dim() < 2 or leaf in _BIASES or leaf in ("conv_w", "a_log",
                                                  "r_gates"):
        return None
    if ".moe." in name and leaf in ("wi", "wg", "wo"):
        return (1,)                              # (E, in, out)
    if leaf == "wo" and t.dim() == 3:
        return (0, 1)                            # attention (H, hd, d)
    if leaf == "tokens":
        return (1,)                              # the tied readout
    return (0,)


def cell_collectives(desc: dict, inputs, model, mesh) -> List[
        Tuple[str, str, float]]:
    """(formula key, HLO kind, per-chip operand bytes) of each collective
    the cell's layout implies on ``mesh`` (:data:`COLLECTIVE_FORMULAS`).
    The port runs none of them: they are counted."""
    cfg, st = model.cfg, desc["settings"]
    kind = desc["kind"]
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    d_ax, m_ax, p_ax = (sizes.get(a, 1) for a in ("data", "model", "pod"))
    params = inputs[0]
    b, s = desc["global_batch"], desc["seq_len"]
    b_chip = b // (p_ax * d_ax) if kind != "decode" else b
    act = params["tokens"].element_size()
    out = []

    def add(key, op, n):
        if n > 0:
            out.append((key, op, float(n)))

    if kind in ("train", "prefill"):
        mb = st["microbatches"] if kind == "train" else 1
        remat = st["remat"] != "none"
        uses = mb * (1 + remat) if kind == "train" else 1
        for name, t in params.items():
            own = _shard_elems(t, mesh) * t.element_size()
            split = "data" in t.spec.axes()
            if split and d_ax > 1:
                for _ in range(uses):
                    add("fsdp_all_gather", "all-gather", own)
            if kind != "train":
                continue
            for _ in range(mb):
                if split and d_ax > 1:
                    add("grad_reduce_scatter", "reduce-scatter", own * d_ax)
                elif d_ax > 1:
                    add("grad_all_reduce_data", "all-reduce", own)
            if p_ax > 1:
                add("grad_all_reduce_pod", "all-reduce",
                    own // t.element_size() if desc.get("compress") else own)
        per_region = (mb * (2 + remat)) if kind == "train" else 1
        region = (b_chip // mb if kind == "train" else b_chip) * s \
            * cfg.d_model * act
        for name, t in params.items():
            if not (name.endswith(_ROW_PARALLEL) and m_ax > 1
                    and t.spec and t.spec[0] == "model"):
                continue
            for _ in range(per_region):
                if st["seq_parallel"]:
                    add("tp_all_reduce", "reduce-scatter", region)
                    add("tp_all_reduce", "all-gather", region / m_ax)
                else:
                    add("tp_all_reduce", "all-reduce", region)
        return out

    # decode: partial sums of the weight-stationary products
    e_pad = padded_experts(cfg) if cfg.is_moe else 0
    if cfg.is_moe:
        sg = _group_size(b)
        cap = max(int(cfg.capacity_factor * cfg.experts_per_token * sg
                      / e_pad), 4)
    for name, t in params.items():
        dims = _contraction(name, t)
        if dims is None or not any(
                t.spec[i] if i < len(t.spec) else None for i in dims):
            continue
        f = split_factors(t.shape, t.spec, mesh)
        if math.prod(f[i] for i in dims) == 1:
            continue
        outs = [i for i in range(t.dim()) if i not in dims]
        feats = math.prod(t.shape[i] // f[i] for i in outs)
        rows = b
        if ".moe." in name and name.rsplit(".", 1)[-1] in ("wi", "wg", "wo"):
            rows = (b // sg) * cap                   # each expert's buffer
        add("decode_partial_sums", "all-reduce", rows * feats * 4)
    state = inputs[1]
    if state.k.shape[0]:
        f = split_factors(state.k.shape, state.k.spec, mesh)
        if f[2] > 1:                                  # the sequence is split
            per_layer = (b // f[1]) * cfg.n_heads * (cfg.head_dim + 2) * 4
            for _ in range(state.k.shape[0]):
                add("decode_partial_sums", "all-reduce", per_layer)
    return out


def analyze_cell(cost: dict, desc: dict, inputs, model, mesh) -> dict:
    """The per-chip roofline row of a counted cell on ``mesh``: JAX's
    ``analyze_compiled`` keys where they apply.

    ``cost`` is :func:`sharded_cost`'s count of the global step (or a
    :func:`combine` of counts); its work splits over the chips by the
    roles (:func:`per_chip`).  The collectives are
    :func:`cell_collectives`', reported through
    :func:`repro_torch.kernels.count_collective` and summed by
    :func:`.collectives.parse_collectives`.  ``memory_analysis`` holds
    ``argument_size_in_bytes``: the inputs' ``shard_shape`` bytes, set
    against the H100's 80 GB.  The compute term is at the peak of the
    type the port's products run in, float32 (``desc["dtype"]``).
    """
    from .analysis import model_flops, roofline_terms
    from .constants import CHIP, PEAK_BY_DTYPE
    split = per_chip(cost, mesh)
    records: list = []
    WORK_COUNTS.append(records)
    try:
        coll = cell_collectives(desc, inputs, model, mesh)
        for _, op, n in coll:
            count_collective(op, [_meta(n)])
    finally:
        WORK_COUNTS.remove(records)
    collectives = parse_collectives(
        [(name, work(*data)) for name, work, data, _ in records])
    by_formula: Dict[str, float] = collections.defaultdict(float)
    for key, _, n in coll:
        by_formula[key] += n
    collectives["by_formula"] = dict(by_formula)
    collectives["formulas"] = {k: COLLECTIVE_FORMULAS[k] for k in by_formula}
    args = argument_bytes(inputs, mesh)
    arg_total = sum(args.values())
    n_chips = mesh.size
    dtype = desc.get("dtype", "float32")
    terms = roofline_terms(
        hlo_flops_per_chip=split["flops"], hlo_bytes_per_chip=split["bytes"],
        collective_bytes_per_chip=collectives["total_bytes"],
        peak_flops=PEAK_BY_DTYPE[dtype])
    mf = model_flops(desc["n_params"], desc.get("n_active_params", 0),
                     desc["tokens"], desc["kind"])
    mf_per_chip = mf / n_chips
    flops = split["flops"]
    return {
        **desc,
        "dtype": dtype,
        "n_chips": n_chips,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": split["bytes"],
        "global_flops": cost["flops"],
        "global_bytes": cost["bytes"],
        "bytes_by_op": cost["bytes_by_op"],
        "kernels": split["kernels"],
        "collectives": collectives,
        "memory_analysis": {
            "argument_size_in_bytes": int(arg_total),
            "hbm_bytes": CHIP["hbm_bytes"],
            "argument_fraction_of_hbm": arg_total / CHIP["hbm_bytes"]},
        "argument_bytes_by_leaf": args,
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": (mf_per_chip / flops) if flops else 0.0,
        "step_time_bound_s": terms["bound_s"],
        "model_flops_utilization_bound": (
            mf_per_chip / PEAK_BY_DTYPE[dtype] / terms["bound_s"]
            if terms["bound_s"] > 0 else 0.0),
    }
