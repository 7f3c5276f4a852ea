"""Benchmark-cell construction: (arch x shape x mesh) -> a step to count.

The port of ``repro/launch/cells.py``.  One entry point,
:func:`build_cell`, returns what the dry-run needs: the step function
and its inputs, each a tensor that carries its
:class:`~repro_torch.models.params.Spec` (``.spec``).  On a mesh that
only describes a layout (the production meshes) every input is a
``meta`` tensor, the counterpart of JAX's ``ShapeDtypeStruct``: nothing
is allocated for the full-size configs.  On a mesh that holds a device
(:func:`~repro_torch.launch.mesh.single_device_mesh`) the inputs are
real: the weights drawn from ``seed``, a batch's tokens too, the
optimizer state, the decode state and a decode step's tokens at their
starting values (zeros).

Cell kinds (configs/base.py):

* train   -> the port's train step (loss + grad + clip + AdamW), with
             per-arch microbatching from :data:`DRYRUN_SETTINGS`;
* prefill -> the batched kernel forward (logits), the serving prefill
             phase;
* decode  -> one-token serve step over the full-length KV cache, every
             sequence at one position (``uniform_pos``), with the
             weight-stationary layout: the one-token activations are
             replicated, so the weights are never gathered.

Also the per-cell FleetPlane deployment hook, :func:`cell_tenant`, and
the cell-kind priorities it defaults to.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..configs import get_config, get_shape
from ..configs.base import ArchConfig, InputShape
from ..fleet.specs import TenantSpec
from ..models import decode as D
from ..models.params import MULTI_POD_AXES, Axes, Spec, axes_for
from ..models.transformer import Model
from ..optim.adamw import AdamWState, opt_state_specs
from ..train.step import (TrainState, TrainStepConfig, bind_params,
                          build_train_step)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@dataclass(frozen=True)
class CellSettings:
    microbatches: int = 1
    remat: str = "full"
    attn_impl: str = "chunked"
    attn_chunk: int = 1024
    params_dtype: str = "bfloat16"
    seq_parallel: bool = False


# Per-arch dry-run knobs for the train_4k cell (1M tokens/step): the
# microbatch count is the activation-memory lever.
DRYRUN_SETTINGS: Dict[Tuple[str, str], CellSettings] = {
    ("mistral-large-123b", "train_4k"): CellSettings(microbatches=16),
    ("dbrx-132b", "train_4k"): CellSettings(microbatches=2),
    ("llama-3.2-vision-11b", "train_4k"): CellSettings(microbatches=4),
    ("whisper-large-v3", "train_4k"): CellSettings(microbatches=4),
    ("qwen2-moe-a2.7b", "train_4k"): CellSettings(microbatches=2),
    ("hymba-1.5b", "train_4k"): CellSettings(microbatches=2),
}


def cell_settings(arch: str, shape: str) -> CellSettings:
    return DRYRUN_SETTINGS.get((arch, shape), CellSettings())


def _device(mesh) -> torch.device:
    """Where a cell's inputs live: ``meta`` on a mesh that only
    describes a layout, else the mesh's one device."""
    if mesh.devices is None:
        return torch.device("meta")
    if len(set(mesh.devices)) != 1:
        raise ValueError("a cell runs on one device; a mesh of several "
                         "is counted on meta (a mesh without devices)")
    return mesh.devices[0]


def sds(shape, dtype, spec: Spec, device="meta",
        roles: Optional[Spec] = None) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` (a name or a torch dtype) on
    ``device`` that carries its ``spec``, and ``roles``, the same
    tensor's spec under the multi-pod axes, from which the dry-run reads
    which logical axes split it (``spec`` when None).  On meta it stands
    where JAX's ``ShapeDtypeStruct`` does; elsewhere it is zeros."""
    dtype = DTYPES.get(dtype, dtype)
    t = torch.zeros(tuple(shape), dtype=dtype, device=device)
    return carry(t, spec, roles)


def carry(t: torch.Tensor, spec: Spec,
          roles: Optional[Spec] = None) -> torch.Tensor:
    """``t`` with ``.spec`` and ``.roles`` set (see :func:`sds`)."""
    t.spec = spec
    t.roles = spec if roles is None else roles
    return t


def batch_inputs(cfg: ArchConfig, shape: InputShape, axes: Axes, mesh, *,
                 with_labels: bool, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The tokens (B, S) int32, with ``labels`` for training, and the
    vlm family's ``images`` (B, vision tokens, d) or the audio family's
    ``frames`` (B, S, d) in bfloat16: the batch dim over the batch axes.
    On a device, tokens and labels are drawn from ``seed`` and the
    images or frames are standard normals from it."""
    b, s = shape.global_batch, shape.seq_len
    dev = _device(mesh)

    def leaf(shp, dtype):
        rest = [None] * (len(shp) - 1)
        return sds(shp, dtype, axes.batch_spec(*rest), dev,
                   MULTI_POD_AXES.batch_spec(*rest))

    batch = {"tokens": leaf((b, s), "int32")}
    if with_labels:
        batch["labels"] = leaf((b, s), "int32")
    if cfg.family == "audio":
        batch["frames"] = leaf((b, s, cfg.d_model), "bfloat16")
    if cfg.family == "vlm":
        batch["images"] = leaf((b, cfg.vision_tokens, cfg.d_model),
                               "bfloat16")
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, t in batch.items():
                if t.dtype == torch.int32:
                    t.copy_(torch.randint(0, cfg.vocab_size, t.shape,
                                          generator=gen, device=dev))
                else:
                    t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    return batch


def _mesh_dm(mesh) -> Tuple[int, int]:
    return mesh.axis_size("data"), mesh.axis_size("model")


def build_cell(arch: Union[str, ArchConfig], shape: Union[str, InputShape],
               mesh, settings: Optional[CellSettings] = None, *,
               seed: int = 0) -> Tuple[Callable, tuple, dict]:
    """-> (fn, example inputs (a tuple of trees of tensors that carry
    their specs), description dict).

    ``arch`` is a name of the registry or an :class:`ArchConfig` (a
    config cut in depth); ``shape`` a name of
    :data:`~repro_torch.configs.SHAPES` or an :class:`InputShape` (a
    cell's shape cut to size, keeping its kind).
    ``fn(*inputs)`` is the cell's step: ``train`` the port's train step
    (``(params, TrainState, batch) -> (params, state, metrics)``),
    ``prefill`` :meth:`Model.forward`'s logits, ``decode``
    :func:`~repro_torch.models.decode.decode_step` with ``uniform_pos``
    (``(params, DecodeState, tokens) -> logits``, the state updated in
    place).  ``fn.model`` is the model it binds ``params`` into.
    """
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    shape = get_shape(shape) if isinstance(shape, str) else shape
    if not cfg.supports_shape(shape):
        raise ValueError(f"{arch} skips {shape.name} (full attention at "
                         f"500k)")
    st = settings or cell_settings(arch, shape.name)
    axes = axes_for(mesh)
    dev = _device(mesh)
    model = Model(cfg, seed=seed, dtype=DTYPES[st.params_dtype], device=dev,
                  init=dev.type != "meta", remat=st.remat,
                  attn_impl=st.attn_impl, attn_chunk=st.attn_chunk)
    pspecs = model.specs(axes)
    proles = model.specs(MULTI_POD_AXES)
    params = {}
    for n, p in model.named_parameters():
        carry(p, pspecs[n], proles[n])        # the gradient hooks read it
        params[n] = carry(p.detach(), pspecs[n], proles[n])

    desc = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            # decode steps process one token per sequence
            "tokens": (shape.global_batch if shape.kind == "decode"
                       else shape.tokens),
            "global_batch": shape.global_batch, "seq_len": shape.seq_len,
            "settings": dataclasses.asdict(st),
            "sharding_report": cfg.sharding_report(*_mesh_dm(mesh))}

    if shape.kind == "train":
        tcfg = TrainStepConfig(microbatches=st.microbatches)
        step = build_train_step(model, tcfg)
        ospecs = opt_state_specs(pspecs)
        oroles = opt_state_specs(proles)
        moments = [{n: sds(p.shape, "float32", ospecs.mu[n], dev,
                           oroles.mu[n]) for n, p in params.items()}
                   for _ in range(2)]
        state = TrainState(
            adam=AdamWState(step=sds((), "int32", ospecs.step, dev),
                            mu=moments[0], nu=moments[1]),
            compression=None)
        batch = batch_inputs(cfg, shape, axes, mesh, with_labels=True,
                             seed=seed)
        step.model = model
        return step, (params, state, batch), desc

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            bind_params(model, params)
            with torch.no_grad():
                return model(batch["tokens"], images=batch.get("images"),
                             frames=batch.get("frames"))

        batch = batch_inputs(cfg, shape, axes, mesh, with_labels=False,
                             seed=seed)
        prefill_fn.model = model
        return prefill_fn, (params, batch), desc

    # decode: weight-stationary, every sequence at one position
    b, s = shape.global_batch, shape.seq_len
    state = D.init_state(model, b, s)
    sspecs = D.state_specs(model, b, s, axes)
    sroles = D.state_specs(model, b, s, MULTI_POD_AXES)
    for f in dataclasses.fields(state):
        t, sp, ro = (getattr(x, f.name) for x in (state, sspecs, sroles))
        if isinstance(t, torch.Tensor):
            carry(t, sp, ro)
        elif t is not None:                   # the ssm family's tree
            for key, leaves in t.items():
                for name, leaf in leaves.items():
                    carry(leaf, sp[key][name], ro[key][name])
    # the one-token activations are replicated, so the weights split
    # over every axis are never gathered: each matmul sums partials
    tok = sds((b, 1), "int32", Spec(None, None), dev)

    def serve_fn(params, state, tokens):
        bind_params(model, params)
        with torch.no_grad():
            return D.decode_step(model, state, tokens, uniform_pos=True)

    serve_fn.model = model
    return serve_fn, (params, state, tok), desc


# ---------------------------------------------------------------------------
# Per-cell FleetPlane deployment
# ---------------------------------------------------------------------------

# Serving cells are latency-critical (decode above prefill); training
# tolerates throughput dips, so it arbitrates at the bottom.
DEFAULT_CELL_PRIORITY: Dict[str, int] = {"decode": 2, "prefill": 1,
                                         "train": 0}


def cell_tenant(arch: str, shape_name: str, *, plane,
                weight: Optional[float] = None,
                priority: Optional[int] = None,
                floor_gib: float = 0.0) -> TenantSpec:
    """Wrap one benchmark cell's memory plane as a fleet tenant.

    A cell (arch x shape) that declares a host-memory ``PlaneSpec`` for
    its dataset / KV caches becomes a
    :class:`~repro_torch.fleet.specs.TenantSpec` that a
    :class:`~repro_torch.fleet.specs.FleetSpec` can arbitrate beside
    other cells sharing the host.  Defaults derive from the cell
    itself: ``weight`` scales with active parameters (bigger models keep
    more working state per node), ``priority`` from the cell kind
    (:data:`DEFAULT_CELL_PRIORITY` -- serving above training).
    """
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if weight is None:
        weight = max(cfg.n_active_params() / 1e9, 0.25)
    if priority is None:
        priority = DEFAULT_CELL_PRIORITY.get(shape.kind, 0)
    return TenantSpec(name=f"{arch}:{shape_name}", plane=plane,
                      weight=float(weight), priority=int(priority),
                      floor_gib=float(floor_gib))
