"""Roofline of one step of the port, counted as it runs, on the H100's
published peaks.

Three terms per step, in seconds (``analyze_step``):
  compute    = the step's operations / the peak rate of the type each
               computes in (a float32 product with TF32 off at the
               float32 rate, bf16 on the tensor cores at the bf16 rate)
  memory     = the bytes its operators read and write / HBM bandwidth
  collective = the bytes the step's collectives move / (chips x NVLink
               bandwidth); 0 without a mesh

Under a mesh (DTensors, ``launch/partition.py``) the counter counts what
this rank runs: it leaves each DTensor operator to DTensor and counts the
operators DTensor then runs on this rank's blocks, so ``flops`` and
``hbm_bytes`` are one rank's (work replicated over a mesh axis counts in
full on every rank that does it) and the compute and memory terms are
that rank's times.  The collectives of DTensor's redistributions, those
inside an operator (a weight gathered before a product, a partial sum
reduced after one) and the explicit ones (``sharded.local_block``), reach
the counter as ``_c10d_functional`` operators: each is counted by kind
under the JAX package's names (``all-gather``, ``all-reduce``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``) with its
output's bytes, as ``collective_bytes_from_hlo`` counts an HLO
collective's result shape, and kept out of ``hbm_bytes``; the collective
term is their bytes over (ranks x NVLink bandwidth), the JAX package's
formula.  The operators that DTensor's sharding propagation runs on fake
tensors to learn an output's shape (once per operator and shapes) are not
counted.

The JAX package reads these from XLA's ``cost_analysis`` and HLO text
(``repro.roofline.analysis.analyze_compiled``); torch has neither, so
``analyze_step`` runs the step once under a dispatch mode that sees every
aten operator: its operations by ``FlopCounterMode``'s per-operator
formulas (matmuls, convolutions, attention), its bytes as each
operator's tensor inputs and outputs (a view, or an allocation that
writes nothing, moves none; a gather such as the embedding's lookup reads
only the rows it gathers, a scatter writes only its values).  The hand
kernels launch through ctypes, where no operator is seen: each dispatcher
reports the work its call needs (``kernels/work.py``) and the operators
inside the call are left out, so a step counts the same whether its
kernels or their plain versions run (on the card or on the CPU).

``model_flops`` and ``active_param_count`` are the JAX package's
arithmetic, unchanged.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import work

# NVIDIA H100 SXM5, its data sheet's dense peaks at 700 W (the rates
# chip_smoke.py takes)
PEAK_FLOPS = 989e12        # bf16 on the tensor cores, dense
PEAK_FLOPS_TF32 = 495e12   # tf32 on the tensor cores, dense
PEAK_FLOPS_FP32 = 67e12    # float32 outside the tensor cores (TF32 off)
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4, one direction

# allocations that write nothing, and ``_unsafe_view``, a view whose schema
# does not say so
_NO_BYTES = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
             torch.ops.aten.empty_like, torch.ops.aten.new_empty,
             torch.ops.aten.new_empty_strided, torch.ops.aten._unsafe_view}
# a gather reads the rows it gathers, not its whole source (the first
# argument); a scatter writes its values' positions, not its whole target
_GATHERS = {torch.ops.aten.index, torch.ops.aten.embedding,
            torch.ops.aten.index_select, torch.ops.aten.gather}
_SCATTERS = {torch.ops.aten.index_put, torch.ops.aten.index_put_,
             torch.ops.aten._index_put_impl_}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# torch's collective operators by the JAX package's (XLA's) names; the
# other operators of these namespaces (waits, autograd wrappers) move
# nothing
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def peak_flops(dtype) -> float:
    """The peak rate of products in ``dtype`` on the card: bf16 / fp16 on
    the tensor cores; float32 at the TF32 rate where cuBLAS may use TF32,
    else outside the tensor cores."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_FLOPS
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return PEAK_FLOPS_TF32
    return PEAK_FLOPS_FP32


def _moves_nothing(func) -> bool:
    """A view (every result aliases an input, none written) or a bare
    allocation."""
    if func._overloadpacket in _NO_BYTES:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bytes(func, args, kwargs, out) -> int:
    """The bytes an operator moves: its tensor inputs read and outputs
    written once; nothing for a view or a bare allocation; a gather's rows
    read and written (with its indices), a scatter's values read and
    written (with its indices)."""
    packet = func._overloadpacket
    if _moves_nothing(func):
        return 0
    if packet in _GATHERS:
        return _nbytes(_tensors((args[1:], kwargs))) + 2 * _nbytes(_tensors(out))
    if packet in _SCATTERS:
        indices, values = _tensors(args[1]), _tensors(args[2:3])
        return _nbytes(indices) + 2 * _nbytes(values)
    return _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))


class _Counter(TorchDispatchMode):
    """The operators of one step and the dispatchers' reported calls."""

    def __init__(self):
        super().__init__()
        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self.hidden = 0            # > 0 inside a reported call
        from torch.distributed.tensor import DTensor

        self.dtensor = DTensor
        self.ops: dict[str, dict] = {}
        self.kernels: dict[str, dict] = {}
        self.flops_by_type: dict[str, int] = {}
        self.collectives = {"bytes_by_kind": dict.fromkeys(_COLLECTIVES, 0),
                            "counts": dict.fromkeys(_COLLECTIVES, 0)}

    @staticmethod
    def _add(table: dict, name: str, flops: int, nbytes: int) -> None:
        row = table.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        row["calls"] += 1
        row["flops"] += int(flops)
        row["bytes"] += int(nbytes)

    def _typed(self, flops: int, dtype) -> None:
        if flops:
            key = str(dtype).replace("torch.", "")
            self.flops_by_type[key] = self.flops_by_type.get(key, 0) + int(flops)

    def enter(self, name: str, flops: int, nbytes: int, dtype) -> None:
        if not self.hidden:
            self._add(self.kernels, name, flops, nbytes)
            self._typed(flops, dtype)
        self.hidden += 1

    def exit(self) -> None:
        self.hidden -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self.dtensor) for t in types):
            return NotImplemented      # DTensor runs it; its local operators come here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                 # DTensor's sharding propagation
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_KIND.get(func._opname)
            if kind is not None:       # counted inside reported calls too
                self.collectives["bytes_by_kind"][kind] += _nbytes(_tensors(out))
                self.collectives["counts"][kind] += 1
            return out
        if self.hidden:
            return out
        flops = 0
        fn = self.flop_registry.get(func._overloadpacket)
        if fn is not None:
            flops = fn(*args, **kwargs, out_val=out)
            self._typed(flops, _tensors((args, kwargs))[0].dtype)
        self._add(self.ops, str(func._overloadpacket), flops,
                  _bytes(func, args, kwargs, out))
        return out


def count_step(fn, *args, **kwargs):
    """(the counter, the outputs) of one call ``fn(*args, **kwargs)``."""
    counter = _Counter()
    if work._counter is not None:
        raise RuntimeError("analyze_step does not nest")
    work._counter = counter
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        work._counter = None
    return counter, out


def record(counter, mesh=None) -> dict:
    """The roofline record of a counted call (``analyze_step``'s)."""
    chips = 1 if mesh is None else mesh.size()
    tables = (counter.ops, counter.kernels)
    flops = sum(r["flops"] for t in tables for r in t.values())
    hbm_bytes = sum(r["bytes"] for t in tables for r in t.values())
    compute_s = sum(f / peak_flops(getattr(torch, t))
                    for t, f in counter.flops_by_type.items())
    coll = {**counter.collectives,
            "total_bytes": sum(counter.collectives["bytes_by_kind"].values())}
    terms = {"compute_s": compute_s, "memory_s": hbm_bytes / HBM_BW,
             "collective_s": (coll["total_bytes"] / (chips * LINK_BW)
                              if mesh is not None else 0.0)}
    return {"flops": flops, "hbm_bytes": hbm_bytes,
            "flops_by_type": dict(counter.flops_by_type),
            "kernels": counter.kernels, "ops": counter.ops, "collectives": coll,
            "roofline": {**terms, "dominant": max(terms, key=terms.get),
                         "chips": chips}}


def analyze_step(fn, *args, mesh=None, **kwargs) -> dict:
    """Roofline record of one call ``fn(*args, **kwargs)``, in the JAX
    package's shape: ``flops``, ``hbm_bytes``, ``collectives``
    {``bytes_by_kind``, ``counts``, ``total_bytes``} and ``roofline``
    {``compute_s``, ``memory_s``, ``collective_s``, ``dominant``,
    ``chips``}; also ``flops_by_type``, ``kernels`` (each dispatcher's
    calls, flops and bytes) and ``ops`` (each operator's).  ``mesh``: the
    device mesh the call's DTensors live on (its ranks are the chips);
    the counts are then this rank's.
    The call runs once (its outputs are dropped); only integers are
    counted, so two runs on the same shapes and data give the same
    record."""
    counter, _ = count_step(fn, *args, **kwargs)
    return record(counter, mesh)


def model_flops(cfg, shape) -> float:
    """6 * N_active * D tokens (training; inference: 2*N_active*D)."""
    n_active = active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def active_param_count(cfg) -> int:
    """Parameters touched per token (MoE: top_k experts only)."""
    d, V = cfg.d_model, cfg.vocab
    hd = cfg.resolved_head_dim
    total = V * d  # embed (readout tied or separate counted once)
    if not cfg.tie_embeddings:
        total += V * d
    from repro_torch.models.backbone import sublayer_specs
    specs = sublayer_specs(cfg)
    per_sb = 0
    for s in specs:
        if s["kind"] == "attn":
            per_sb += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
        elif s["kind"] == "mamba":
            h = cfg.hybrid
            di = h.expand * d
            per_sb += d * 2 * di + di * d + di * (max(1, d // 16) + 2 * h.d_state) \
                + max(1, d // 16) * di
        elif s["kind"] in ("mlstm", "slstm"):
            per_sb += 4 * d * d if s["kind"] == "mlstm" else 8 * d * d
        if s["ffn"] == "dense":
            per_sb += 3 * d * cfg.d_ff if cfg.norm == "rmsnorm" else 2 * d * cfg.d_ff
        elif s["ffn"] == "moe":
            per_sb += 3 * d * cfg.moe.expert_d_ff * cfg.moe.top_k
            if cfg.moe.dense_residual_ff:
                per_sb += 3 * d * cfg.moe.dense_residual_ff
            if cfg.moe.shared_expert_ff:
                per_sb += 3 * d * cfg.moe.shared_expert_ff
            per_sb += d * cfg.moe.n_experts  # router
    total += per_sb * cfg.n_superblocks
    if cfg.encdec is not None:
        enc = cfg.encdec.n_encoder_layers * (4 * d * d + 2 * d * cfg.d_ff)
        total += enc + cfg.n_layers * (4 * d * d)   # cross-attention
    return int(total)
