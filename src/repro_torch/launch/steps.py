"""The LM steps on one device and their input specs, as
``repro.launch.steps``.

``make_train_step``: SGD-momentum with gradient accumulation over
microbatches; ``n_microbatches`` picks their count from the width.  The
arithmetic is JAX's: the microbatch gradients summed into fp32 zeros in
order and divided by their count, the loss as the sum of loss / n, then
``new_m`` / ``new_p`` in fp32 and cast back to each leaf's dtype.  bf16
params (the MoE archs at full size) give bf16 gradients, as
``jax.value_and_grad`` does; ``bf16_grads`` casts the gradient to
bfloat16 as JAX does, on its one-microbatch branch only.

Where JAX scans the microbatches inside one jitted program, the port loops
over them eagerly, each through ``repro_torch.value_and_grad`` of
``models/backbone.py::forward_loss``; the accumulation is in place.

``make_serve_step`` (one decode step) and ``make_prefill_step`` wrap the
backbone's ``decode_step`` and ``prefill``.  The specs
(``make_batch_specs``, ``params_specs``, ``opt_specs``, ``cache_specs``)
are tensors on torch's ``meta`` device, JAX's ShapeDtypeStructs: shapes
and dtypes, nothing allocated and nothing drawn (``nn/init.py`` draws no
weight for a meta tensor), so arctic-480b's tree costs milliseconds.

Under a mesh the steps take DTensors (``launch/partition.py``): host-made
tensors stand replicated, and the train step reduces each gradient into
its param's placements (the data-parallel all-reduce or reduce-scatter)
and returns the loss whole.  ``Strategy``, ``BASELINE`` and
``OPTIMIZED_STRATEGIES`` are the JAX package's sharding knobs;
``batch_shardings`` and ``lower_step`` place a step's arguments on a mesh
as ``lower_step`` does there, as meta DTensors, and ``Lowered.compile``
runs the step once under the roofline counter (the dry-run,
``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import sharded, tree_leaves, tree_map, value_and_grad
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import axis_names, axis_size, data_axes
from repro_torch.launch.partition import NamedSharding, replicated
from repro_torch.models import backbone as bb


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Sharding strategy knob set.

    model_axes: mesh axes carrying tensor parallelism for params
      ()                 -> pure data parallel (small dense models)
      ("model",)         -> baseline 1D TP
      ("data", "model")  -> all-rank TP (big-model decode)
    fsdp: override FSDP weight sharding (None = per-kind default)
    expert_data_sharding: resident 2D expert placement, experts over the
      data axes x expert-ff over the model axes (no per-microbatch
      gathers of expert weights)
    n_micro: gradient-accumulation override
    bf16_grads: cast grads to bf16 before the reduction
    """
    model_axes: tuple = ("model",)
    fsdp: "bool | None" = None
    expert_data_sharding: bool = False
    n_micro: "int | None" = None
    bf16_grads: bool = False

    def batch_axes(self, mesh) -> tuple:
        return tuple(a for a in axis_names(mesh) if a not in self.model_axes)


BASELINE = Strategy()

# the JAX package's optimized strategies, by (arch, shape)
OPTIMIZED_STRATEGIES: dict[tuple, Strategy] = {
    # pure DP, replicated fp32 params
    ("qwen2-0.5b", "train_4k"): Strategy(model_axes=(), fsdp=False),
    # resident 2D expert sharding + reduced grad accumulation
    ("arctic-480b", "train_4k"): Strategy(expert_data_sharding=True, n_micro=4),
    # all-rank tensor parallelism, resident weights
    ("jamba-1.5-large-398b", "decode_32k"): Strategy(
        model_axes=("data", "model"), fsdp=False),
}


def n_microbatches(cfg: ArchConfig, shape: InputShape) -> int:
    """Gradient-accumulation factor: keeps per-device activation memory
    bounded for the wide architectures (power of two, divides batch)."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 7000:
        n = 16
    elif cfg.d_model >= 4096:
        n = 8
    elif cfg.d_model >= 1536:
        n = 2
    else:
        n = 1
    while shape.global_batch % n:
        n //= 2
    return max(1, n)


def make_batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta tensors of one training / prefill batch: a VLM's ``patches``
    (B, P, vision_dim) and an enc-dec's ``frames`` (B, F, d) in cfg.dtype,
    ``tokens`` (and, to train, ``labels``) (B, T - P) int32."""
    B, T = shape.global_batch, shape.seq_len
    meta = {"device": "meta"}
    batch = {}
    t_text = T
    if cfg.vlm is not None:
        batch["patches"] = torch.empty((B, cfg.vlm.n_patches, cfg.vlm.vision_dim),
                                       dtype=cfg.dtype, **meta)
        t_text = T - cfg.vlm.n_patches
    if cfg.encdec is not None:
        batch["frames"] = torch.empty((B, cfg.encdec.n_frames, cfg.d_model),
                                      dtype=cfg.dtype, **meta)
    batch["tokens"] = torch.empty((B, t_text), dtype=torch.int32, **meta)
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, t_text), dtype=torch.int32, **meta)
    return batch


def batch_shardings(cfg: ArchConfig, batch_specs: dict, mesh,
                    strategy: "Strategy | None" = None) -> dict:
    """Each batch leaf's leading axis over the strategy's batch axes,
    dropping trailing axes until the global batch divides (pure-DP batch
    256 on the 512-rank multi-pod mesh shards over (pod, data) = 32 and
    leaves "model" as pure replication); replicated when none divides."""
    axes = (strategy or BASELINE).batch_axes(mesh)

    def sharding_for(v):
        use = list(axes)
        while use:
            size = axis_size(mesh, use)
            if v.shape[0] % size == 0 and v.shape[0] >= size:
                return NamedSharding(mesh, [tuple(use)] + [None] * (v.dim() - 1))
            use.pop()
        return replicated(mesh, v.dim())

    return {k: sharding_for(v) for k, v in batch_specs.items()}


def params_specs(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors: ``init_params``' structure,
    shapes and dtypes, with nothing drawn or allocated."""
    return bb.init_params(cfg, device="meta")


def opt_specs(params_sds) -> dict:
    return {"momentum": params_sds}


def cache_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The decode cache of ``shape`` (its batch and context) as meta
    tensors; ``long_500k`` takes the long-context window."""
    return bb.init_cache(cfg, shape.global_batch, shape.seq_len,
                         long_context=shape.name == "long_500k", device="meta")


def opt_init(params) -> dict:
    """The train step's optimizer state: zero momentum in each param's
    dtype (``repro.launch.steps.opt_specs``' tree)."""
    return {"momentum": tree_map(torch.zeros_like, params)}


def make_train_step(cfg: ArchConfig, shape: InputShape, *,
                    lr: float = 1e-3, momentum: float = 0.9,
                    weight_decay: float = 0.0,
                    n_micro_override: "int | None" = None,
                    bf16_grads: bool = False):
    """(params, opt, batch) -> (params, opt, {"loss"}) with microbatching.

    batch: {"tokens", "labels"} of (B, T) integers (tensors or numpy, moved
    to the params' device); B must split into the microbatches.  Returns
    new trees; the inputs are left as they are."""
    n_micro = n_micro_override or n_microbatches(cfg, shape)
    window = cfg.sliding_window

    def loss_fn(params, mb):
        return bb.forward_loss(cfg, params, mb, window=window)

    def train_step(params, opt, batch):
        with sharded.host_replicated(sharded.mesh_of(params)):
            return _train_step(params, opt, batch)

    def _train_step(params, opt, batch):
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if n_micro == 1:
            (loss, _), grads = value_and_grad(lambda p: loss_fn(p, batch), params)
            if bf16_grads:
                grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        else:
            mbs = {k: _microbatches(v, n_micro) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            loss = torch.zeros((), device=dev)
            for i in range(n_micro):
                mb = {k: v[i] for k, v in mbs.items()}
                (loss_i, _), g = value_and_grad(lambda p: loss_fn(p, mb), params)
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                loss = loss + loss_i / n_micro
                del g
            grads = tree_map(lambda g: g / n_micro, grads)
        # under a mesh: each gradient reduced into its param's placements
        # (the data-parallel all-reduce / reduce-scatter), the loss whole
        grads = tree_map(sharded.like, grads, params)
        loss = sharded.like(loss, None)

        with torch.no_grad():
            def new_m(p, g, m):
                g32 = g.float() + weight_decay * p.float()
                return (momentum * m.float() + g32).to(m.dtype)

            def new_p(p, m):
                return (p.float() - lr * m.float()).to(p.dtype)

            m_upd = tree_map(new_m, params, grads, opt["momentum"])
            p_upd = tree_map(new_p, params, m_upd)
        return p_upd, {"momentum": m_upd}, {"loss": loss}

    return train_step


def _microbatches(v, n_micro: int):
    """``v``'s rows as ``n_micro`` microbatches (index i for the i-th):
    consecutive rows, as the JAX package reshapes them.  A DTensor split
    along its rows gives each microbatch its share of every rank's block
    instead, so that no row moves between ranks: with every microbatch's
    loss a mean over as many labelled tokens, the step's loss and
    gradients are the same sums in another order."""
    if not sharded.is_dtensor(v):
        return v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
    local = v.to_local()
    if local.shape[0] % n_micro:
        raise ValueError(f"{local.shape[0]} rows a rank do not split into "
                         f"{n_micro} microbatches")
    parts = local.reshape((n_micro, local.shape[0] // n_micro) + local.shape[1:])
    shape = (v.shape[0] // n_micro,) + tuple(v.shape[1:])
    return [sharded.wrap(parts[i], v.device_mesh, v.placements, shape)
            for i in range(n_micro)]


def make_serve_step(cfg: ArchConfig, shape: InputShape):
    """(params, tokens (B, 1), cache, cache_len) -> (logits, cache): one
    decode step, the cache written in place."""

    def serve_step(params, tokens, cache, cache_len):
        with sharded.host_replicated(sharded.mesh_of(params)):
            return bb.decode_step(cfg, params, tokens, cache, cache_len)

    return serve_step


def make_prefill_step(cfg: ArchConfig, shape: InputShape):
    """(params, batch) -> (last-token logits, cache) over a context of
    ``shape.seq_len``; ``long_500k`` prefills with the long-context
    window."""
    long = shape.name == "long_500k"

    def prefill_step(params, batch):
        with sharded.host_replicated(sharded.mesh_of(params)):
            logits, cache, _ = bb.prefill(cfg, params, batch, long_context=long,
                                          max_len=shape.seq_len)
        return logits, cache

    return prefill_step


def _param_gib(p_sds) -> float:
    return sum(t.numel() * t.element_size() for t in tree_leaves(p_sds)) / 2**30


def _dsize(mesh) -> int:
    return axis_size(mesh, data_axes(mesh))


# the serving-FSDP rule: weights are 2D-sharded over (data, model) and
# gathered per layer when a model-axis shard of the params would take more
# than 75 % of one card's memory (the JAX package's 12 GiB is 75 % of its
# reference chip's 16 GiB; here the H100's 80 GB)
SERVE_FSDP_GIB = 0.75 * 80e9 / 2**30


@dataclasses.dataclass
class Lowered:
    """A step and its arguments as meta DTensors on a mesh: JAX's
    ``Lowered``.  ``compile()`` runs it once, counting (no XLA to lower
    into: the run is the compile)."""
    fn: object
    args: tuple
    mesh: object

    def compile(self) -> "Compiled":
        from repro_torch import sharded
        from repro_torch.roofline import analysis

        with sharded.host_replicated(self.mesh):
            counter, out = analysis.count_step(self.fn, *self.args)
        return Compiled(analysis.record(counter, self.mesh),
                        {"argument_bytes": _local_bytes(self.args),
                         "output_bytes": _local_bytes(out),
                         "temp_bytes": None, "peak_bytes": None})


@dataclasses.dataclass
class Compiled:
    """A counted step: its roofline record (``analyze_step``'s) and each
    rank's memory: argument and output bytes summed over the local blocks;
    temporaries and the peak, which torch does not know before a run,
    None."""
    analysis: dict
    memory: dict

    def memory_analysis(self) -> dict:
        return self.memory


def _local_bytes(tree) -> int:
    """Bytes one rank holds of a tree's tensors (a DTensor's local block);
    an int argument (the decode step's depth) counts as the int32 scalar
    the JAX package passes."""
    from torch.utils._pytree import tree_flatten

    from repro_torch import sharded

    total = 0
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if sharded.is_dtensor(leaf) else leaf
            total += t.numel() * t.element_size()
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            total += 4
    return total


def lower_step(cfg: ArchConfig, shape: InputShape, mesh, *,
               strategy: "Strategy | None" = None):
    """Build the right step for (cfg, shape) on ``mesh`` and its arguments
    as meta DTensors in the JAX package's placements.  Returns (lowered,
    meta), meta recording what was built.

    Training: FSDP (ZeRO-3-style) param / grad / optimizer sharding over
    the data axes on top of tensor parallelism; serving keeps params
    tensor-parallel only unless a model-axis shard of them exceeds
    SERVE_FSDP_GIB (then 2D-sharded over (data, model) and gathered per
    layer).  The decode step runs at depth ``seq_len - 1``."""
    from repro_torch.launch.partition import cache_shardings, distribute, param_shardings

    strategy = strategy or BASELINE
    p_sds = params_specs(cfg)
    msize = axis_size(mesh, strategy.model_axes)
    serve_fsdp = _param_gib(p_sds) / max(msize, 1) > SERVE_FSDP_GIB
    if shape.kind == "train":
        p_sh = param_shardings(p_sds, mesh, cfg=cfg, fsdp=True, strategy=strategy)
        step = make_train_step(cfg, shape, n_micro_override=strategy.n_micro,
                               bf16_grads=strategy.bf16_grads)
        b_sds = make_batch_specs(cfg, shape)
        args = (distribute(p_sds, p_sh), {"momentum": distribute(p_sds, p_sh)},
                distribute(b_sds, batch_shardings(cfg, b_sds, mesh, strategy)))
        return Lowered(step, args, mesh), {
            "kind": "train", "n_micro": strategy.n_micro or n_microbatches(cfg, shape)}
    p = distribute(p_sds, param_shardings(p_sds, mesh, cfg=cfg, fsdp=serve_fsdp,
                                          strategy=strategy))
    if shape.kind == "prefill":
        b_sds = make_batch_specs(cfg, shape)
        args = (p, distribute(b_sds, batch_shardings(cfg, b_sds, mesh, strategy)))
        return Lowered(make_prefill_step(cfg, shape), args, mesh), {"kind": "prefill"}
    b = shape.global_batch
    tok = torch.empty((b, 1), dtype=torch.int32, device="meta")
    baxes = strategy.batch_axes(mesh)
    bsize = axis_size(mesh, baxes)
    tok_sh = (NamedSharding(mesh, [baxes, None]) if baxes and b >= bsize
              and b % bsize == 0 else replicated(mesh, 2))
    c_sds = cache_specs(cfg, shape)
    cache = distribute(c_sds, cache_shardings(c_sds, mesh, batch=b, cfg=cfg,
                                              strategy=strategy))
    args = (p, tok_sh.distribute(tok), cache, shape.seq_len - 1)
    return Lowered(make_serve_step(cfg, shape), args, mesh), {"kind": "decode"}
