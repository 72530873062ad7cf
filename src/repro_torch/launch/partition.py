"""Name-rule-based parameter partitioning, as ``repro.launch.partition``,
with DTensor placements in place of GSPMD's ``NamedSharding``.

Rules map parameter-path suffixes to *candidate* tensor axes (counted from
the end, so stacked superblock axes never shift a rule) to shard over the
"model" mesh axis; the first candidate that divides wins (e.g. mixtral's
8 experts don't divide a 16-way model axis, so its expert FFNs fall back
to tensor-parallel over d_ff).

FSDP mode (training): after the model axis is placed, the largest
remaining divisible axis is sharded over the data axes (ZeRO-3-style
weight / grad / optimizer sharding; DTensor's redistribution gathers a
weight where an op needs it whole).  Serving keeps params tensor-parallel
only.

A spec is JAX's ``PartitionSpec`` in canonical form: one entry per tensor
axis, each None, one mesh axis name, or a tuple of names (major to
minor, in the mesh's order).  The rules run on the JAX package's layout
of each leaf, so every decision is the reference's: the port keeps a list
of per-layer dicts where JAX stacks superblocks on a leading axis (the
stacked axis counts in FSDP's size threshold and ordering, and no rule
ever shards it), a Mamba ``conv_w`` transposed, and its K/V cache's
(superblock, layer) axes merged into one.  ``NamedSharding`` holds the
spec in the port's layout; ``placements`` turns it into DTensor
placements and ``distribute`` (``jax.device_put``) cuts each rank's local
block out of a full tensor that every rank holds, so the rows a rank
holds are JAX's: a tensor axis over ("pod", "data") splits pod-major.
Every sharded axis divides its mesh axes, as JAX's rules guarantee; an
uneven split raises.
"""
from __future__ import annotations

import re

import torch

from repro_torch import tree_map
from repro_torch.launch.mesh import axis_names, axis_size, axis_sizes, data_axes

# (path regex, candidate axes-from-end for the "model" axis)
# order matters: first matching rule wins; first dividing candidate wins.
_RULES: list[tuple[str, tuple[int, ...]]] = [
    (r"embed/table$", (2, 1)),         # (V, d): vocab, else d
    (r"lm_head/w$", (1, 2)),           # (d, V)
    (r"attn/w[qkv]/w$", (1, 2)),       # (d, H*hd): column parallel
    (r"attn/w[qkv]/b$", (1,)),
    (r"attn/wo/w$", (2, 1)),           # (H*hd, d): row parallel
    (r"cross/w[qkv]/w$", (1, 2)),
    (r"cross/wo/w$", (2, 1)),
    (r"ffn/(gate|up)/w$", (1, 2)),
    (r"ffn/down/w$", (2, 1)),
    (r"ffn/fc1/w$", (1, 2)),
    (r"ffn/fc1/b$", (1,)),
    (r"ffn/fc2/w$", (2, 1)),
    (r"(dense_res|shared)/(gate|up)/w$", (1, 2)),
    (r"(dense_res|shared)/down/w$", (2, 1)),
    (r"moe/(gate|up)$", (3, 1, 2)),    # (E, d, ff): experts, else ff, else d
    (r"moe/down$", (3, 2, 1)),         # (E, ff, d): experts, else ff
    (r"mamba/in_proj/w$", (1, 2)),     # (d, 2*di)
    (r"mamba/out_proj/w$", (2, 1)),    # (di, d)
    (r"mamba/conv_w$", (1,)),          # (k, 1, di)
    (r"mamba/conv_b$", (1,)),
    (r"mamba/x_proj/w$", (2,)),        # (di, r+2s): row parallel
    (r"mamba/dt_proj/w$", (1,)),       # (r, di)
    (r"mamba/dt_bias$", (1,)),
    (r"mamba/A_log$", (2,)),           # (di, s)
    (r"mamba/D$", (1,)),
    (r"cell/w[qkv]/w$", (1, 2)),       # mLSTM projections
    (r"cell/out/w$", (2, 1)),
    (r"cell/wx/w$", (1, 2)),           # sLSTM gates (d, 4d)
    (r"cell/wx/b$", (1,)),
    (r"cell/wr/w$", (1, 2)),
    (r"vision_proj/w$", (1, 2)),
]

_FSDP_MIN_ELEMENTS = 1 << 18            # don't bother sharding small tensors


def _spec_for(path: str, shape, model_size: int, *, fsdp_axes=None,
              fsdp_size: int = 1, model_axes=("model",),
              expert_axes=None, expert_size: int = 1) -> tuple:
    """The JAX package's ``_spec_for`` on a leaf of the JAX layout (its
    path and shape), as a tuple with one entry per axis."""
    ndim = len(shape)
    spec: list = [None] * ndim
    is_expert = bool(re.search(r"moe/(gate|up|down)$", path))
    if is_expert and expert_axes:
        # 2D resident expert sharding: expert axis over `expert_axes`,
        # matmul axis over the model axes, no FSDP gathers
        e_axis = ndim - 3
        if shape[e_axis] % expert_size == 0 and shape[e_axis] >= expert_size:
            spec[e_axis] = expert_axes
        ff_from_end = 1 if re.search(r"moe/(gate|up)$", path) else 2
        ff_axis = ndim - ff_from_end
        if model_size > 1 and shape[ff_axis] % model_size == 0:
            spec[ff_axis] = model_axes if len(model_axes) > 1 else model_axes[0]
        return tuple(spec)
    if model_size > 1:
        for pattern, candidates in _RULES:
            if re.search(pattern, path):
                for axis_from_end in candidates:
                    axis = ndim - axis_from_end
                    if 0 <= axis < ndim and shape[axis] % model_size == 0 \
                            and shape[axis] >= model_size:
                        spec[axis] = (model_axes if len(model_axes) > 1
                                      else model_axes[0])
                        break
                break
    if fsdp_axes and _numel(shape) >= _FSDP_MIN_ELEMENTS:
        # largest remaining divisible axis over the data axes
        order = sorted(range(ndim), key=lambda i: -shape[i])
        for i in order:
            if spec[i] is None and shape[i] % fsdp_size == 0 \
                    and shape[i] >= fsdp_size:
                spec[i] = fsdp_axes
                break
    return tuple(spec)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def canonical(entry):
    """One spec entry in canonical form: None, a name, or a tuple of two or
    more names (JAX accepts ("data",) for "data")."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


def _names(entry) -> tuple:
    entry = canonical(entry)
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A spec on a mesh (a ``DeviceMesh``, or a ``MeshShape`` for specs
    alone): JAX's ``NamedSharding``.  ``spec`` is canonical, one entry per
    axis of the port's tensor."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(canonical(e) for e in spec)
        order = axis_names(mesh)
        used = []
        for e in self.spec:
            names = _names(e)
            idx = [order.index(n) for n in names]
            if idx != sorted(idx):
                raise ValueError(f"spec {self.spec}: {names} are not in the "
                                 f"mesh's order {order}")
            used += names
        if len(used) != len(set(used)):
            raise ValueError(f"spec {self.spec} uses a mesh axis twice")

    def placements(self) -> list:
        """DTensor placements, one per mesh axis: Shard(d) where tensor axis
        d's entry names it, else Replicate()."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in axis_names(self.mesh):
            dims = [d for d, e in enumerate(self.spec) if name in _names(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def shard_shape(self, shape) -> tuple:
        """Each rank's block of a tensor of global ``shape``; an axis that
        does not divide its mesh axes raises."""
        if len(shape) != len(self.spec):
            raise ValueError(f"spec {self.spec} for a shape {tuple(shape)}")
        out = []
        for n, e in zip(shape, self.spec):
            k = axis_size(self.mesh, _names(e))
            if n % k:
                raise ValueError(f"axis of {n} does not divide {k} ways "
                                 f"(spec {self.spec}, shape {tuple(shape)})")
            out.append(n // k)
        return tuple(out)

    def local_slices(self, shape, coordinate) -> tuple:
        """The index of the block the rank at ``coordinate`` (one index per
        mesh axis) holds: along each sharded axis, block number
        sum(c_a * prod(sizes after a)) over its mesh axes, major to minor."""
        sizes = axis_sizes(self.mesh)
        where = dict(zip(axis_names(self.mesh), coordinate))
        block = self.shard_shape(shape)
        out = []
        for b, e in zip(block, self.spec):
            i = 0
            for name in _names(e):
                i = i * sizes[name] + where[name]
            out.append(slice(i * b, (i + 1) * b))
        return tuple(out)

    def distribute(self, t: torch.Tensor):
        """``t`` (the full tensor, the same on every rank) as a DTensor whose
        local block is this rank's: ``jax.device_put`` with this
        sharding.  Moves nothing between ranks."""
        from torch.distributed.tensor import DTensor

        local = t[self.local_slices(t.shape, self.mesh.get_coordinate())]
        return DTensor.from_local(local.contiguous(), self.mesh, self.placements(),
                                  run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape, device="meta").stride())


def distribute(tree, shardings):
    """A tree of full tensors as DTensors, leaf by leaf."""
    return tree_map(lambda t, s: s.distribute(t), tree, shardings)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a port tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _stacks(cfg, params) -> dict:
    """How many of the port's layers the JAX package stacks into each of
    its leaves: superblocks for the decoder's layer list (one leaf per
    sublayer of a superblock), every layer for an enc-dec's lists."""
    from repro_torch.models.backbone import sublayer_specs

    out = {}
    for key in ("blocks", "encoder"):
        if key in params:
            period = (len(sublayer_specs(cfg)) if key == "blocks"
                      and cfg.encdec is None else 1)
            out[key] = len(params[key]) // period
    return out


def _param_view(path: str, shape, stacks: dict):
    """(JAX's shape of this leaf, the port axis of each JAX axis: None for
    the stacked one)."""
    top = path.split("/", 1)[0]
    if top not in stacks:
        return tuple(shape), list(range(len(shape)))
    if re.search(r"mamba/conv_w$", path):       # port (di, 1, k), JAX (k, 1, di)
        return (stacks[top], shape[2], shape[1], shape[0]), [None, 2, 1, 0]
    return (stacks[top],) + tuple(shape), [None] + list(range(len(shape)))


def _to_port(path: str, jax_spec, axes, ndim: int) -> tuple:
    spec: list = [None] * ndim
    for entry, port_axis in zip(jax_spec, axes):
        if port_axis is None:
            if entry is not None:
                raise ValueError(f"{path}: the JAX rules shard its stacked "
                                 f"layer axis ({jax_spec}), which the port's "
                                 "per-layer tensors cannot carry")
            continue
        spec[port_axis] = entry
    return tuple(spec)


def param_shardings(params, mesh, *, cfg, fsdp: bool = False, strategy=None):
    """Tree of NamedShardings aligned with a params tree (tensors, meta
    tensors included).  fsdp=True additionally shards params over the
    data axes (training).  ``strategy`` (launch.steps.Strategy) overrides
    the model-parallel axes / expert placement.  ``cfg`` gives the JAX
    package's stacking of the layer lists."""
    model_axes = ("model",)
    expert_axes = None
    if strategy is not None:
        model_axes = strategy.model_axes
        if strategy.expert_data_sharding:
            expert_axes = data_axes(mesh)
        if strategy.fsdp is not None:
            fsdp = strategy.fsdp
    model_size = axis_size(mesh, model_axes)
    daxes = tuple(a for a in axis_names(mesh) if a not in model_axes)
    dsize = axis_size(mesh, daxes)
    e_size = axis_size(mesh, expert_axes) if expert_axes else 1
    stacks = _stacks(cfg, params)

    def rule(path, leaf):
        shape, axes = _param_view(path, tuple(leaf.shape), stacks)
        jax_spec = _spec_for(
            path, shape, model_size,
            fsdp_axes=(daxes if (fsdp and daxes) else None), fsdp_size=dsize,
            model_axes=model_axes, expert_axes=expert_axes,
            expert_size=e_size)
        return NamedSharding(mesh, _to_port(path, jax_spec, axes, leaf.dim()))

    return map_with_path(rule, params)


def pool_shardings(pool, mesh, *, model_axes=("model",)):
    """Shardings for a decode slot pool (``serve.scheduler``): every leaf
    leads with the slot axis, which shards over the data axes, so a slot
    lives wholly on one data shard and host-side evict / inject touch
    exactly that shard's rows.  The port's cache K/V leaves are (L, S, W,
    Hkv, D), JAX's (n_sb, n_layer, S, W, Hkv, hd) with the (superblock,
    layer) axes merged: the slot axis second, and model-parallel over
    kv-heads when divisible, matching the tensor-parallel attention
    params.  Axes that don't divide stay replicated, so a 1-device mesh
    degenerates to the unsharded layout."""
    daxes = data_axes(mesh)
    dsize = axis_size(mesh, daxes)
    msize = axis_size(mesh, model_axes)
    dval = canonical(daxes)
    mval = canonical(tuple(model_axes))

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if re.search(r"(^|/)(k|v)$", path):
            if len(shape) != 5:
                raise ValueError(f"pool leaf {path}: {shape}, expected (L, S, W, Hkv, D)")
            if dval is not None and shape[1] % dsize == 0:
                spec[1] = dval
            if mval is not None and msize > 1 and shape[3] % msize == 0:
                spec[3] = mval
            return NamedSharding(mesh, spec)
        if dval is not None and shape[0] % dsize == 0:
            spec[0] = dval
        return NamedSharding(mesh, spec)

    return map_with_path(rule, pool)


def batch_spec(mesh, ndim: int, *, batch_axis: int = 0) -> NamedSharding:
    """Shard dim ``batch_axis`` over the data axes."""
    spec: list = [None] * ndim
    spec[batch_axis] = data_axes(mesh)
    return NamedSharding(mesh, spec)


def replicated(mesh, ndim: int = 0) -> NamedSharding:
    return NamedSharding(mesh, [None] * ndim)


def _cache_view(path: str, shape, cfg):
    """(JAX's shape of this cache leaf, the port axis of each JAX axis: the
    port's attention K/V merges JAX's (superblock, layer) axes into its
    first)."""
    if cfg.encdec is None and re.search(r"(^|/)(k|v)$", path):
        n_sb = cfg.n_superblocks
        return (n_sb, shape[0] // n_sb) + tuple(shape[1:]), [0, 0, 1, 2, 3, 4]
    return tuple(shape), list(range(len(shape)))


def cache_model_axis(shape, size: int, *, start: int = 0, kv: bool = False,
                     taken=()) -> int | None:
    """The axis of a decode-cache leaf ``shape`` that the model axes
    (``size`` ranks) split: for a K / V leaf its kv heads, then its
    slots; then the first axis from the end that ``size`` divides, down to
    ``start`` (the axis after the batch's), skipping ``taken``; None where
    none divides.  ``cache_shardings``' rule, and the placement a meshed
    layer writes a prefill's state in (``sharded.state_out``)."""
    ndim = len(shape)
    cand = list(range(ndim - 1, start - 1, -1))
    if kv and ndim >= 3:
        cand = [ndim - 2, ndim - 3] + cand  # heads first, then sequence
    for i in cand:
        if i not in taken and shape[i] % size == 0 and shape[i] >= size:
            return i
    return None


def cache_shardings(cache, mesh, *, batch: int, cfg, strategy=None):
    """Shardings for a decode cache tree: batch dim over the batch axes
    when divisible; one model-parallel dim chosen by divisibility
    (kv-heads, then sequence / feature).  The rule runs on the JAX
    package's layout of each leaf (``cfg`` gives its superblocks)."""
    model_axes = ("model",) if strategy is None else strategy.model_axes
    daxes = tuple(a for a in axis_names(mesh) if a not in model_axes)
    dsize = axis_size(mesh, daxes)
    msize = axis_size(mesh, model_axes)
    model_val = canonical(tuple(model_axes))

    def rule(path, leaf):
        shape, axes = _cache_view(path, tuple(leaf.shape), cfg)
        ndim = len(shape)
        spec: list = [None] * ndim
        b_idx = None
        for i, s in enumerate(shape):
            if s == batch:
                b_idx = i
                break
        if b_idx is not None and daxes and batch % dsize == 0 and batch >= dsize:
            spec[b_idx] = daxes
        start = (b_idx + 1) if b_idx is not None else 0
        i = cache_model_axis(shape, msize, start=start,
                             kv=bool(re.search(r"(^|/)(k|v|ck|cv)$", path)),
                             taken={j for j, e in enumerate(spec) if e is not None})
        if model_val is not None and i is not None:
            spec[i] = model_val
        port: list = [None] * leaf.dim()
        for i, (entry, port_axis) in enumerate(zip(spec, axes)):
            if entry is None:
                continue
            # a merged (superblock, layer) axis carries the superblocks'
            # split, or the layers' when there is one superblock (or when
            # the split is one way)
            inner = (i > 0 and axes[i - 1] == port_axis and shape[i - 1] > 1
                     and axis_size(mesh, _names(entry)) > 1)
            if port[port_axis] is not None or inner:
                raise ValueError(f"cache leaf {path}: JAX's spec {spec} shards "
                                 "an inner layer axis the port merges")
            port[port_axis] = entry
        return NamedSharding(mesh, port)

    return map_with_path(rule, cache)
