"""The port's step specs and serve / prefill steps
(``repro_torch.launch.steps``) against the JAX package's
(``repro.launch.steps``), on the CPU.

- ``make_batch_specs``: keys, shapes and dtypes equal JAX's for every
  assigned arch at every assigned shape.
- ``params_specs`` at full size: the same total element count and bytes
  by dtype as JAX's ``eval_shape`` tree, with nothing drawn or allocated
  (every leaf a meta tensor; the weight draws and the kernel wrappers
  refuse to run meanwhile); on the reduced configs every leaf equals the
  JAX tree's, bridged by ``backbone_params_from_numpy``, in shape and
  dtype.
- ``cache_specs``: the same keys, dtypes and shapes as JAX's (the port
  keeps the attention layers' K/V on one (L, ...) axis where JAX stacks
  (n_superblocks, per superblock, ...)).
- ``make_prefill_step`` / ``make_serve_step`` give the backbone's
  ``prefill`` / ``decode_step`` bitwise (reduced qwen2-0.5b).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import tree_leaves  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, get_shape  # noqa: E402
from repro_torch.kernels.attention import ops as attention_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import backbone as bb  # noqa: E402

SHAPE_NAMES = sorted(SHAPES)


def _name(dtype) -> str:
    """A JAX / numpy or torch dtype as its short name ('float32', ...)."""
    return str(dtype).replace("torch.", "") if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype).name


def _by_dtype(leaves) -> dict:
    """{dtype name: [elements, bytes]} over a list of leaves."""
    out = {}
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        row = out.setdefault(_name(leaf.dtype), [0, 0])
        row[0] += n
        row[1] += n * (leaf.element_size() if isinstance(leaf, torch.Tensor)
                       else np.dtype(leaf.dtype).itemsize)
    return out


@pytest.fixture
def no_draws(monkeypatch):
    """The weight draws and the kernel wrappers raise while the specs are
    built: a spec draws nothing and reaches no kernel."""
    def refuse(*a, **k):
        raise AssertionError("a spec drew weights or reached a kernel")

    for mod, name in ((torch, "randn"), (torch, "rand"), (torch.nn.init, "trunc_normal_"),
                      (attention_ops, "flash_attention_cuda"),
                      (attention_ops, "flash_attention_ref"),
                      (decode_ops, "decode_attention_cuda"),
                      (decode_ops, "decode_attention_ref"),
                      (rmsnorm_ops, "rmsnorm_cuda"), (rmsnorm_ops, "rmsnorm_ref")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_specs_equal_jax(arch, shape, no_draws):
    got = steps.make_batch_specs(get_config(arch), get_shape(shape))
    want = jsteps.make_batch_specs(jax_get_config(arch), JAX_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert _name(t.dtype) == _name(want[k].dtype), k


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_params_specs_full_size_equal_jax_allocating_nothing(arch, no_draws):
    """arctic-480b's 484 B parameters and jamba's 399 B cost nothing: the
    tree is meta tensors, drawn by no generator."""
    tree = steps.params_specs(get_config(arch))
    leaves = tree_leaves(tree)
    assert all(t.device.type == "meta" for t in leaves)
    want = jax.tree_util.tree_leaves(jsteps.params_specs(jax_get_config(arch)))
    assert _by_dtype(leaves) == _by_dtype(want)
    assert steps.opt_specs(tree) == {"momentum": tree}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_params_specs_reduced_equal_bridged_jax_tree(arch):
    """Leaf by leaf, in the port's layout: JAX's reduced tree (zeros of
    its eval_shape) moved over by the bridge."""
    cfg = get_config(arch).reduced()
    jtree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   jsteps.params_specs(jax_get_config(arch).reduced()))
    want = tree_leaves(backbone_params_from_numpy(jtree, cfg, device="cpu"))
    got = tree_leaves(steps.params_specs(cfg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_equal_jax(arch, shape, no_draws):
    cfg = get_config(arch)
    got = steps.cache_specs(cfg, get_shape(shape))
    want = jsteps.cache_specs(jax_get_config(arch), JAX_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        w = tuple(want[k].shape)
        if k in ("k", "v") and cfg.encdec is None:   # (n_sb, n_attn, ...) -> (L, ...)
            w = (w[0] * w[1],) + w[2:]
        assert tuple(t.shape) == w, k
        assert _name(t.dtype) == _name(want[k].dtype), k


@pytest.fixture(scope="module")
def small():
    cfg = get_config("qwen2-0.5b").reduced()
    params = bb.init_params(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab, (2, 12)))
    return cfg, params, tokens


@pytest.mark.parametrize("name", ["prefill_32k", "long_500k"])
def test_prefill_step_is_the_backbone_prefill(small, name):
    cfg, params, tokens = small
    shape = dataclasses.replace(get_shape(name), seq_len=24, global_batch=2)
    logits, cache = steps.make_prefill_step(cfg, shape)(params, {"tokens": tokens})
    ref_logits, ref_cache, _ = bb.prefill(cfg, params, {"tokens": tokens},
                                          long_context=name == "long_500k", max_len=24)
    assert torch.equal(logits, ref_logits)
    assert sorted(cache) == sorted(ref_cache)
    assert all(torch.equal(cache[k], ref_cache[k]) for k in cache)
    assert cache["k"].shape[2] == 24


def test_serve_step_is_the_backbone_decode_step(small):
    cfg, params, tokens = small
    shape = dataclasses.replace(get_shape("decode_32k"), seq_len=24, global_batch=2)
    _, cache = steps.make_prefill_step(cfg, shape)(params, {"tokens": tokens})
    ref_cache = {k: v.clone() for k, v in cache.items()}
    tok = tokens[:, -1:]
    logits, out = steps.make_serve_step(cfg, shape)(params, tok, cache, 12)
    ref_logits, ref_out = bb.decode_step(cfg, params, tok, ref_cache, 12)
    assert torch.equal(logits, ref_logits)
    assert out is cache
    assert all(torch.equal(out[k], ref_out[k]) for k in out)
