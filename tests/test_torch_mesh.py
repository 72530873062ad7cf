"""The port's placements (``repro_torch.launch.partition``) against the JAX
package's, leaf by leaf, with no process group: both sides read a mesh's
shape and axis names only (JAX's ``AbstractMesh``, the port's
``MeshShape``).

- ``param_shardings`` for all ten ``ASSIGNED_ARCHS`` at full size (the
  port's meta specs against ``repro.launch.steps.params_specs``), on the
  production meshes (16, 16) and (2, 16, 16) and on (4, 2) and (1, 1),
  FSDP on and off, under ``BASELINE`` and the three
  ``OPTIMIZED_STRATEGIES``.  The port keeps a list of per-layer dicts
  where JAX stacks superblocks on a leading axis, and a Mamba ``conv_w``
  transposed: each port spec is mapped back to JAX's layout (the stacked
  axis unsharded) and must equal JAX's spec there.
- ``cache_shardings`` and ``batch_shardings`` for every arch and input
  shape on the same meshes and strategies (the port's K/V cache merges
  JAX's (superblock, layer) axes), and ``pool_shardings`` on a slot pool.
- JAX's ten tests/test_partition.py claims on the port's ``_spec_for``.
- ``NamedSharding``'s placements and the rows a rank holds: a tensor axis
  over ("pod", "data") splits pod-major.
- The strategies equal JAX's, and the serving-FSDP rule: with JAX's 12
  GiB the decisions equal JAX's, and on the H100's 80 GB only the archs
  listed in SERVE_FSDP_DIFFERS decide otherwise.
"""
import re

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import get_shape as jax_get_shape  # noqa: E402
from repro.launch import partition as jpart  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.nn.module import map_with_path as jax_map_with_path  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, get_shape  # noqa: E402
from repro_torch.launch import partition, steps  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.backbone import sublayer_specs  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
STRATEGIES = [None] + sorted(jsteps.OPTIMIZED_STRATEGIES)
# archs whose serving-FSDP decision on a 16-way model axis differs between
# JAX's 12 GiB (75 % of its reference chip) and 75 % of the H100's 80 GB
SERVE_FSDP_DIFFERS = ["jamba-1.5-large-398b"]

_JAX_PARAMS: dict = {}
_PORT_PARAMS: dict = {}


def _params(arch):
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = jsteps.params_specs(jax_get_config(arch))
        _PORT_PARAMS[arch] = steps.params_specs(get_config(arch))
    return _JAX_PARAMS[arch], _PORT_PARAMS[arch]


def _canon(spec, ndim):
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(partition.canonical(e) for e in entries)


def _jax_specs(shardings, shapes):
    leaves, specs = {}, {}
    jax_map_with_path(lambda p, leaf: leaves.__setitem__(p, leaf.shape), shapes)
    jax_map_with_path(lambda p, s: specs.__setitem__(p, _canon(s.spec, len(leaves[p]))),
                      shardings)
    return specs


def _port_as_jax(cfg, shardings):
    """Each port leaf's spec in JAX's layout, by JAX's path: a layer list's
    leaves gather under their sublayer's JAX path, the stacked axis
    unsharded."""
    per = len(sublayer_specs(cfg))
    out: dict = {}
    leaves: list = []
    partition.map_with_path(lambda path, sh: leaves.append((path, sh)), shardings)
    for path, sh in leaves:
        parts = path.split("/")
        spec = sh.spec
        if parts[0] in ("blocks", "encoder"):
            j = int(parts[1])
            keep = [str(j % per)] if parts[0] == "blocks" and cfg.encdec is None else []
            path = "/".join([parts[0]] + keep + parts[2:])
            if re.search(r"mamba/conv_w$", path):
                spec = (spec[2], spec[1], spec[0])
            spec = (None,) + tuple(spec)
        out.setdefault(path, set()).add(spec)
    return out


def _strategies(name):
    if name is None:
        return None, None
    return jsteps.OPTIMIZED_STRATEGIES[name], steps.OPTIMIZED_STRATEGIES[name]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_jax(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    jp, pp = _params(arch)
    cfg = get_config(arch)
    jm, pm = AbstractMesh(shape, names), MeshShape(shape, names)
    n = 0
    for fsdp in (False, True):
        for name in STRATEGIES:
            jst, pst = _strategies(name)
            want = _jax_specs(jpart.param_shardings(jp, jm, fsdp=fsdp, strategy=jst), jp)
            got = _port_as_jax(cfg, partition.param_shardings(pp, pm, cfg=cfg, fsdp=fsdp,
                                                              strategy=pst))
            assert sorted(got) == sorted(want)
            for path, spec in want.items():
                assert got[path] == {spec}, (path, fsdp, name, got[path], spec)
                n += 1
    assert n == 8 * len(want)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_and_batch_specs_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for shape_name in SHAPES:
        js, ps = jax_get_shape(shape_name), get_shape(shape_name)
        jc, pc = jsteps.cache_specs(jcfg, js), steps.cache_specs(cfg, ps)
        jb, pb = jsteps.make_batch_specs(jcfg, js), steps.make_batch_specs(cfg, ps)
        assert sorted(jc) == sorted(pc) and sorted(jb) == sorted(pb)
        for shape, names in MESHES.values():
            jm, pm = AbstractMesh(shape, names), MeshShape(shape, names)
            for name in STRATEGIES:
                jst, pst = _strategies(name)
                jsh = jpart.cache_shardings(jc, jm, batch=js.global_batch, strategy=jst)
                psh = partition.cache_shardings(pc, pm, batch=ps.global_batch, cfg=cfg,
                                                strategy=pst)
                for k in jc:
                    want = _canon(jsh[k].spec, jc[k].ndim)
                    if k in ("k", "v") and cfg.encdec is None:
                        # the port's first axis is JAX's (superblock, layer)
                        want = (want[0] if want[1] is None else want[1],) + want[2:]
                    assert psh[k].spec == want, (shape_name, shape, name, k)
                jbs = jsteps.batch_shardings(jcfg, jb, jm, jst)
                pbs = steps.batch_shardings(cfg, pb, pm, pst)
                for k in jb:
                    assert pbs[k].spec == _canon(jbs[k].spec, jb[k].ndim)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_pool_specs_equal_jax(mesh_name):
    """A slot pool of 32 slots, 2 layers and 16 KV heads: the port's (L, S,
    W, Hkv, D) K/V against JAX's (n_sb, n_layer, S, W, Hkv, hd)."""
    import torch

    shape, names = MESHES[mesh_name]
    S, W, L = 32, 64, 2
    port = {"buf": torch.empty(S, 48, device="meta"), "done": torch.empty(S, device="meta"),
            "cache": {"k": torch.empty(L, S, W, 16, 64, device="meta"),
                      "v": torch.empty(L, S, W, 16, 64, device="meta")}}
    jpool = {"buf": jax.ShapeDtypeStruct((S, 48), np.int32),
             "done": jax.ShapeDtypeStruct((S,), bool),
             "cache": {"k": jax.ShapeDtypeStruct((L, 1, S, W, 16, 64), np.float32),
                       "v": jax.ShapeDtypeStruct((L, 1, S, W, 16, 64), np.float32)}}
    jsh = jpart.pool_shardings(jpool, AbstractMesh(shape, names))
    psh = partition.pool_shardings(port, MeshShape(shape, names))
    for k in ("buf", "done"):
        assert psh[k].spec == _canon(jsh[k].spec, jpool[k].ndim)
    for k in ("k", "v"):
        want = _canon(jsh["cache"][k].spec, 6)
        assert want[:2] == (None, None)
        assert psh["cache"][k].spec == (None,) + want[2:]


def spec(path, shape, model=16, fsdp=False, dsize=16):
    return partition._spec_for(path, shape, model,
                               fsdp_axes=("data",) if fsdp else None, fsdp_size=dsize)


def _has_data(s):
    return any(x in ("data", ("data",)) for x in s)


# tests/test_partition.py's ten claims, on the port's rule
PARTITION_CLAIMS = {
    "embed_vocab_sharded_when_divisible":
        lambda: spec("embed/table", (151936, 896)) == ("model", None),
    "embed_fallback_to_dmodel_for_odd_vocab":
        lambda: spec("embed/table", (151655, 896)) == (None, "model"),
    "attention_col_and_row_parallel":
        lambda: (spec("blocks/0/attn/wq/w", (24, 896, 896)) == (None, None, "model")
                 and spec("blocks/0/attn/wo/w", (24, 896, 896)) == (None, "model", None)),
    "moe_expert_parallel_when_divisible":
        lambda: spec("blocks/0/moe/gate", (35, 128, 7168, 4864)) == (None, "model", None, None),
    "moe_tensor_parallel_fallback_small_expert_count":
        lambda: (spec("blocks/0/moe/gate", (32, 8, 4096, 14336)) == (None, None, None, "model")
                 and spec("blocks/0/moe/down", (32, 8, 14336, 4096))
                 == (None, None, "model", None)),
    "qwen_attention_head_fallback":
        lambda: "model" in spec("blocks/0/attn/wq/w", (24, 896, 896)),
    "fsdp_adds_data_axis":
        lambda: (spec("blocks/0/ffn/gate/w", (32, 4096, 14336), fsdp=True).count("model") == 1
                 and _has_data(spec("blocks/0/ffn/gate/w", (32, 4096, 14336), fsdp=True))),
    "fsdp_skips_small_tensors":
        lambda: not _has_data(spec("blocks/0/norm/scale", (32, 896), fsdp=True)),
    "norms_replicated":
        lambda: all(x is None for x in spec("blocks/0/norm/scale", (24, 896))),
    "every_rule_pattern_is_valid_regex":
        lambda: all(re.compile(p) and all(c >= 1 for c in cand)
                    for p, cand in partition._RULES),
}


@pytest.mark.parametrize("claim", list(PARTITION_CLAIMS))
def test_partition_claim(claim):
    assert PARTITION_CLAIMS[claim]()


def test_rules_are_jaxs():
    assert partition._RULES == jpart._RULES
    assert partition._FSDP_MIN_ELEMENTS == jpart._FSDP_MIN_ELEMENTS


def test_pod_data_axis_splits_pod_major():
    """A (8, 3) tensor over ("pod", "data") on a (2, 2, 2) mesh: the rank
    at (pod p, data d) holds rows block 2 p + d, whatever its model
    coordinate; DTensor's placements shard axis 0 on both mesh axes."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape((2, 2, 2), ("pod", "data", "model"))
    sh = partition.NamedSharding(mesh, [("pod", "data"), None])
    assert sh.placements() == [Shard(0), Shard(0), Replicate()]
    assert sh.shard_shape((8, 3)) == (2, 3)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                rows = sh.local_slices((8, 3), (p, d, m))[0]
                assert (rows.start, rows.stop) == (2 * (2 * p + d), 2 * (2 * p + d) + 2)
    with pytest.raises(ValueError, match="order"):
        partition.NamedSharding(mesh, [("data", "pod"), None])
    with pytest.raises(ValueError, match="divide"):
        sh.shard_shape((6, 3))


def test_strategies_are_jaxs():
    assert sorted(steps.OPTIMIZED_STRATEGIES) == sorted(jsteps.OPTIMIZED_STRATEGIES)
    for key, st in jsteps.OPTIMIZED_STRATEGIES.items():
        assert vars(steps.OPTIMIZED_STRATEGIES[key]) == vars(st)
    assert vars(steps.BASELINE) == vars(jsteps.BASELINE)


def test_serve_fsdp_rule():
    """``_param_gib / msize > threshold`` on a 16-way model axis: JAX's 12
    GiB gives JAX's decisions; the H100's threshold differs only for the
    archs of SERVE_FSDP_DIFFERS."""
    assert steps.SERVE_FSDP_GIB == pytest.approx(0.75 * 80e9 / 2**30)
    differs = []
    for arch in ASSIGNED_ARCHS:
        jp, pp = _params(arch)
        gib = steps._param_gib(pp)
        assert gib == pytest.approx(jsteps._param_gib(jp))
        if (gib / 16 > 12.0) != (gib / 16 > steps.SERVE_FSDP_GIB):
            differs.append(arch)
    assert differs == SERVE_FSDP_DIFFERS
