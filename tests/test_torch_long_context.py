"""``long_context`` in the port's dense backbone on the CPU against the JAX
package: the reduced qwen2-0.5b with ``long_context_window`` cut to 16,
the JAX weights bridged over, a 40-token prompt.  ``cache_window`` and
``init_cache``, the windowed prefill's logits and its 16-slot ring cache,
4 decode steps past the ring's wrap; and, within the port, a prompt no
longer than the window giving what ``long_context=False`` gives.

Tolerances: logits and caches at 1e-5 (fp32 sums run in another order);
window sizes, shapes and the within-port identity exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import backbone as jbb  # noqa: E402
from repro_torch.bridge import backbone_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import backbone as tbb  # noqa: E402

TOL = 1e-5
WINDOW, B, T = 16, 2, 40


def close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=TOL, rtol=TOL)


def _configs(arch="qwen2-0.5b"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), long_context_window=WINDOW),
            dataclasses.replace(get_config(arch).reduced(), long_context_window=WINDOW))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    jp = jbb.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(31).randint(0, cfg.vocab, (B, T)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tokens=tokens, params=backbone_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu"))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-1b", "whisper-tiny"])
@pytest.mark.parametrize("context", [1, 15, 16, 17, 40, 500_000])
def test_cache_window_and_init_cache_match_jax(arch, context):
    jcfg, cfg = _configs(arch)
    for long_context in (False, True):
        S = tbb.cache_window(cfg, context, long_context=long_context)
        assert S == jbb.cache_window(jcfg, context, long_context=long_context)
        if context > 64:
            continue
        jc = jbb.init_cache(jcfg, B, context, long_context=long_context)
        tc = tbb.init_cache(cfg, B, context, long_context=long_context, device="cpu")
        assert sorted(tc) == sorted(jc)
        for name, t in tc.items():
            shape = np.asarray(jc[name]).shape
            if cfg.encdec is None:       # JAX: (n_sb, 1, B, S, Hkv, D)
                shape = shape[:1] + shape[2:]
            assert tuple(t.shape) == shape and not t.any()


@pytest.mark.parametrize("max_len", [0, 64])
def test_prefill_ring_and_decode_past_the_wrap_match_jax(model, max_len):
    """The ring holds min(16, max_len or T + 64) = 16 slots; decode runs
    from position 40 (slot 8) on."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    lj, cj, _ = jbb.prefill(jcfg, model["jp"], {"tokens": jnp.asarray(model["tokens"])},
                            long_context=True, max_len=max_len)
    lt, ct, Tt = tbb.prefill(cfg, model["params"], {"tokens": torch.from_numpy(model["tokens"])},
                             long_context=True, max_len=max_len)
    assert Tt == T
    close(lj, lt)
    for name in ("k", "v"):
        assert ct[name].shape == (cfg.n_layers, B, WINDOW, cfg.n_kv_heads, 64)
        close(np.asarray(cj[name])[:, 0], ct[name])
    # the window attends: the full-attention prefill's logits differ
    full, _, _ = tbb.prefill(cfg, model["params"], {"tokens": torch.from_numpy(model["tokens"])})
    assert (full - lt).abs().max() > 1e-3
    nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for step in range(4):
        lj, cj = jbb.decode_step(jcfg, model["jp"], jnp.asarray(nxt), cj, T + step)
        lt, ct = tbb.decode_step(cfg, model["params"], torch.from_numpy(nxt).long(), ct,
                                 T + step)
        close(lj, lt)
        nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for name in ("k", "v"):
        close(np.asarray(cj[name])[:, 0], ct[name])


@pytest.mark.parametrize("prompt", [5, WINDOW])
def test_prompt_within_the_window_equals_full_attention(model, prompt):
    """T <= window: the windowed prefill is the full one, bitwise, and so
    are 3 decode steps on a ring of max_len = window slots."""
    cfg, params = model["cfg"], model["params"]
    toks = torch.from_numpy(model["tokens"][:, :prompt])
    runs = [tbb.prefill(cfg, params, {"tokens": toks}, long_context=lc, max_len=WINDOW)
            for lc in (True, False)]
    assert torch.equal(runs[0][0], runs[1][0])
    for name in ("k", "v"):
        assert torch.equal(runs[0][1][name], runs[1][1][name])
    nxt = torch.argmax(runs[0][0], -1)[:, None]
    for step in range(min(3, WINDOW - prompt)):
        (la, _), (lb, _) = (tbb.decode_step(cfg, params, nxt, c, prompt + step)
                            for _, c, _ in runs)
        assert torch.equal(la, lb)
        nxt = torch.argmax(la, -1)[:, None]
